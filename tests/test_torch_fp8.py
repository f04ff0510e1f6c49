"""The port's fp8 training path (`accelerate_tpu_torch.ops.fp8`) against the
reference's `accelerate_tpu.ops.fp8`, on the CPU.

The same seeded numpy inputs go through both packages: the fp8 casts byte for
byte, `quantize_dequantize`, the forward and both gradients of `fp8_dot` and
`fp8_dot_native` (the port's CPU product is the plain fp32 product of the
upcast fp8 operands, XLA's on the CPU), the delayed-scaling update,
`Fp8Linear` against `Fp8Dense` over three training calls and `AdamWFp8`
O2 against ``adamw_fp8(opt_level="O2")`` over five steps (the tiny models'
fp8 train steps are in tests/test_torch_fp8_models.py). Then the facade:
``mixed_precision="fp8"``, ``fp8_backend``, the O2 warning, and a
``save_state``/``load_state`` round trip of the scaling buffers and the O2
state.
"""

import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.ops import fp8 as ref  # noqa: E402
from accelerate_tpu.utils.dataclasses import FP8RecipeKwargs as JaxFP8RecipeKwargs  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.models import gpt2  # noqa: E402
from accelerate_tpu_torch.ops import fp8  # noqa: E402
from accelerate_tpu_torch.utils.dataclasses import FP8RecipeKwargs  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# fp32 products of the same fp8 operands, summed in another order
DOT_RTOL = 1e-5
# a bf16 output of those sums: one bf16 step (2^-8 relative) where a sum
# lies near a rounding boundary
BF16_DOT_RTOL = 2 ** -7


def _rng(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------- the casts
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_quantize_is_byte_equal(fmt):
    """100,000 values over 14 decades, scaled and clipped, cast to fp8: the
    port's bytes are the reference's."""
    r = _rng(0)
    x = (r.standard_normal(100_000) * 10.0 ** r.uniform(-8, 6, 100_000)).astype(np.float32)
    jdt, tdt, fmax = ((ref.E4M3, fp8.E4M3, fp8.E4M3_MAX) if fmt == "e4m3"
                      else (ref.E5M2, fp8.E5M2, fp8.E5M2_MAX))
    for scale in (1.0, 37.5, 1e-3):
        want = np.asarray(ref.quantize(jnp.asarray(x), jnp.float32(scale), jdt, fmax))
        got = fp8.quantize(torch.from_numpy(x), torch.tensor(scale), tdt, fmax)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize(dtype):
    r = _rng(1)
    x = r.standard_normal((64, 48)).astype(np.float32) * 3
    scale = np.float32(448 / np.abs(x).max() * 1.5)  # some values clip
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for jdt, tdt, fmax in ((ref.E4M3, fp8.E4M3, 448.0), (ref.E5M2, fp8.E5M2, 57344.0)):
        want = np.asarray(ref.quantize_dequantize(jx, jnp.float32(scale), jdt, fmax).astype(jnp.float32))
        got = fp8.quantize_dequantize(tx, torch.tensor(scale), tdt, fmax)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------- the dots
def _dot_case(seed, dtype):
    r = _rng(seed)
    x = (r.standard_normal((96, 64)) * 2).astype(np.float32)
    k = (r.standard_normal((64, 80)) * 0.1).astype(np.float32)
    g = (r.standard_normal((96, 80)) * 1e-3).astype(np.float32)
    # delayed scales from an earlier amax: x's clips a little, k's has room
    xs = np.float32(448 / (np.abs(x).max() * 0.8))
    ks = np.float32(448 / (np.abs(k).max() * 1.3))
    return x, k, g, xs, ks


@pytest.mark.parametrize("backend", ["native", "qdq"])
@pytest.mark.parametrize("fmt", ["HYBRID", "E4M3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_dot_forward_and_gradients(backend, fmt, dtype):
    x, k, g, xs, ks = _dot_case(2, dtype)
    e4m3 = fmt == "E4M3"
    jfn = ref.fp8_dot_native if backend == "native" else ref.fp8_dot
    tfn = fp8.fp8_dot_native if backend == "native" else fp8.fp8_dot
    jx, jk = jnp.asarray(x).astype(dtype), jnp.asarray(k).astype(dtype)
    out, vjp = jax.vjp(lambda a, b: jfn(a, b, jnp.float32(xs), jnp.float32(ks), e4m3), jx, jk)
    jdx, jdk = vjp(jnp.asarray(g).astype(dtype))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tk = torch.from_numpy(k).to(tdt).requires_grad_()
    got = tfn(tx, tk, torch.tensor(xs), torch.tensor(ks), e4m3)
    got.backward(torch.from_numpy(g).to(tdt))
    rtol = DOT_RTOL if dtype == "float32" else BF16_DOT_RTOL
    for name, a, b in (("out", got, out), ("dx", tx.grad, jdx), ("dk", tk.grad, jdk)):
        b = np.asarray(b.astype(jnp.float32))
        assert a.dtype == tdt, name
        np.testing.assert_allclose(a.detach().float().numpy(), b, rtol=0,
                                   atol=rtol * np.abs(b).max(), err_msg=name)


def test_native_dot_saves_fp8_operands():
    """The native backward keeps the one-byte operands, not the inputs."""
    x, k, g, xs, ks = _dot_case(3, "float32")
    tx, tk = torch.from_numpy(x).requires_grad_(), torch.from_numpy(k).requires_grad_()
    out = fp8.fp8_dot_native(tx, tk, torch.tensor(xs), torch.tensor(ks), False)
    saved = [t.dtype for t in out.grad_fn.saved_tensors]
    assert saved.count(fp8.E4M3) == 2 and torch.float32 not in saved[:2]


@pytest.mark.parametrize("margin", [0, 1])
def test_update_meta(margin):
    r = _rng(4)
    hist = np.zeros(16, np.float32)
    hist[:3] = [0.5, 3.0, 0.25]
    meta_j = {"scale": jnp.float32(7.0), "amax_history": jnp.asarray(hist)}
    meta_t = {"scale": torch.tensor(7.0), "amax_history": torch.from_numpy(hist.copy())}
    for i in range(20):  # the history fills and rolls past its length
        x = r.standard_normal((8, 8)).astype(np.float32) * (i + 1) * 0.3
        meta_j = ref._update_meta(meta_j, jnp.asarray(x), ref.E4M3_MAX, margin)
        meta_t = fp8._update_meta(meta_t, torch.from_numpy(x), fp8.E4M3_MAX, margin)
        for key in ("scale", "amax_history"):
            np.testing.assert_array_equal(meta_t[key].numpy(), np.asarray(meta_j[key]), err_msg=key)
    zero = {"scale": torch.tensor(1.0), "amax_history": torch.zeros(4)}
    assert fp8._update_meta(zero, torch.zeros(3), 448.0, 0)["scale"].item() == 1.0


@pytest.mark.parametrize("backend", ["native", "qdq"])
def test_fp8_linear_matches_fp8_dense(backend):
    """Three training calls (the state advances after each), then one in
    eval mode (it does not): outputs and scaling state agree with the
    reference's ``Fp8Dense`` applied with ``mutable=["fp8_meta"]``."""
    r = _rng(5)
    jr, tr = ref.DelayedScalingRecipe(backend=backend), fp8.DelayedScalingRecipe(backend=backend)
    dense = ref.Fp8Dense(features=24, dtype=jnp.float32, recipe=jr)
    xs = [r.standard_normal((2, 5, 40)).astype(np.float32) * (1 + i) for i in range(4)]
    variables = jax.tree.map(np.asarray, dense.init(jax.random.key(0), jnp.asarray(xs[0])))
    lin = fp8.Fp8Linear(40, 24, recipe=tr, device="cpu")
    meta = fp8.meta_from_jax({"block_0": {"g": {"n": variables["fp8_meta"]}}}, "blocks", "block")
    lin.load_state_dict({"weight": torch.from_numpy(variables["params"]["kernel"].T.copy()),
                         "bias": torch.from_numpy(variables["params"]["bias"].copy()),
                         **{k.rsplit(".", 1)[1]: v for k, v in meta.items()}})
    for i, x in enumerate(xs):
        if i < 3:
            want, state = dense.apply(variables, jnp.asarray(x), mutable=["fp8_meta"])
            variables = {"params": variables["params"], "fp8_meta": state["fp8_meta"]}
        else:
            lin.eval()
            want = dense.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = lin(torch.from_numpy(x), torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=DOT_RTOL * np.abs(np.asarray(want)).max())
        for which in ("input", "kernel"):
            for field in ("scale", "amax_history"):
                np.testing.assert_allclose(getattr(lin, f"{which}_{field}").numpy(),
                                           np.asarray(variables["fp8_meta"][which][field]),
                                           rtol=1e-6, err_msg=f"call {i} {which} {field}")


# --------------------------------------------------------------- AdamW O2
def test_adamw_fp8_o2_matches_the_reference():
    """Five steps over seeded gradients of three magnitudes, with weight
    decay: the e4m3 mu and fp16 nu payloads byte for byte, their scales and
    the parameters (the same fp32 arithmetic in the same order)."""
    r = _rng(6)
    shapes = {"a": (16, 12), "b": (12,), "c": (3, 4, 5)}
    params = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.standard_normal(s) * 10.0 ** r.integers(-6, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    tx = ref.adamw_fp8(1e-2, weight_decay=0.01, opt_level="O2")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = fp8.adamw_fp8(tp.values(), 1e-2, weight_decay=0.01, opt_level="O2")
    assert isinstance(opt, fp8.AdamWFp8)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    adam_state = state[0]
    for k, p in tp.items():
        st = opt.state[p]
        assert st["mu"].dtype == fp8.E4M3 and st["nu"].dtype == torch.float16
        np.testing.assert_array_equal(st["mu"].view(torch.uint8).numpy(),
                                      np.asarray(adam_state.mu[k]).view(np.uint8), err_msg=k)
        np.testing.assert_array_equal(st["nu"].numpy(), np.asarray(adam_state.nu[k]), err_msg=k)
        np.testing.assert_array_equal(st["mu_scale"].numpy(), np.asarray(adam_state.mu_scale[k]))
        np.testing.assert_array_equal(st["nu_scale"].numpy(), np.asarray(adam_state.nu_scale[k]))
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7,
                                   err_msg=k)
    assert isinstance(fp8.adamw_fp8([torch.nn.Parameter(torch.zeros(2))], opt_level="O1"),
                      torch.optim.AdamW)
    with pytest.raises(ValueError, match="opt_level"):
        fp8.adamw_fp8([torch.nn.Parameter(torch.zeros(2))], opt_level="O3")


# ----------------------------------------------------------------- facade
def test_mixed_precision_fp8_and_the_o2_warning():
    acc = Accelerator(mixed_precision="fp8", device="cpu")
    assert acc.policy.compute_dtype == torch.bfloat16 and acc.fp8_backend == "NATIVE"
    assert Accelerator(device="cpu").fp8_backend is None
    handler = FP8RecipeKwargs(opt_level="O2", backend="qdq", margin=1, amax_history_len=8)
    jhandler = JaxFP8RecipeKwargs(opt_level="O2", backend="qdq", margin=1, amax_history_len=8)
    assert vars(handler.to_recipe()) == vars(jhandler.to_recipe())
    acc = Accelerator(device="cpu", kwargs_handlers=[handler])
    assert acc.fp8_backend == "NATIVE"
    model = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(fp8_recipe=handler.to_recipe()), device="cpu")
    with pytest.warns(UserWarning, match="opt_level='O2'"):
        acc.prepare(model, torch.optim.AdamW(model.parameters()))
    acc = Accelerator(device="cpu", kwargs_handlers=[handler])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        acc.prepare(model, fp8.adamw_fp8(model.parameters(), opt_level="O2"))


def test_save_state_round_trips_meta_and_o2_state(tmp_path):
    """Two steps, save, a third step; a fresh accelerator loads the
    checkpoint and takes the third step again: the same parameters, scaling
    state and O2 moments, bit for bit."""
    batches = [torch.from_numpy(_rng(20 + i).integers(0, 256, (2, 16))).long() for i in range(3)]

    def build():
        model = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(fp8_recipe=fp8.DelayedScalingRecipe()),
                                device="cpu", seed=3)
        acc = Accelerator(mixed_precision="fp8", device="cpu")
        model, opt = acc.prepare(model, fp8.adamw_fp8(model.parameters(), 1e-3, opt_level="O2"))
        return acc, model, opt, acc.make_train_step(gpt2.lm_loss_fn)

    acc, model, opt, step = build()
    for b in batches[:2]:
        step({"input_ids": b})
    acc.save_state(str(tmp_path / "ckpt"))
    step({"input_ids": batches[2]})
    want_model = {k: v.clone() for k, v in model.state_dict().items()}
    want_opt = opt.optimizer.state_dict()

    acc2, model2, opt2, step2 = build()
    acc2.load_state(str(tmp_path / "ckpt"))
    assert any(fp8.is_meta_key(k) for k in model2.state_dict())
    step2({"input_ids": batches[2]})
    for k, v in model2.state_dict().items():
        torch.testing.assert_close(v, want_model[k], rtol=0, atol=0, msg=k)
    got_opt = opt2.optimizer.state_dict()
    assert got_opt["param_groups"][0]["count"] == want_opt["param_groups"][0]["count"] == 3
    for i, st in want_opt["state"].items():
        for key, t in st.items():
            assert got_opt["state"][i][key].dtype == t.dtype
            torch.testing.assert_close(got_opt["state"][i][key].float(), t.float(), rtol=0, atol=0)
