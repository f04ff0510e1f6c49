"""The precision slice's CUDA paths against their plain PyTorch versions, on
the card: the fp16 instances of the flash-attention kernels (rectangular and
band) and of the fused-CE kernels, the fp8 GEMM (``torch._scaled_mm``
behind `ops.fp8.fp8_gemm`) at each operand pair the fp8 step uses, an
`Fp8Linear` on the card against the same layer on the CPU, and small fp16
and fp8 training runs through the facade.

Every test needs an NVIDIA Hopper GPU and nvcc and skips elsewhere. The file
imports nothing of JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_precision.py
"""

import pytest
import torch

from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops import fp8
from accelerate_tpu_torch.ops import fused_ce as fc

pytestmark = pytest.mark.cuda

# fp16 kernel against its plain version, |err| <= atol + rtol |plain|: both
# compute in fp32 from the same fp16 operands and round p and dS (flash) or
# dlogits (fused CE) to fp16 before the products, in another summation
# order; a value near an fp16 rounding boundary may round the other way
FP16_TOL = (5e-3, 5e-3)
LSE_ATOL = 1e-4
# fp8 GEMM against the fp32 product of the same fp8 operands: the tensor
# cores' fp8 products accumulate at reduced precision between promotions to
# fp32 (2e-4 of the largest output measured at K 768); a bf16 output rounds
# once more (2^-8 relative)
GEMM_RTOL = {torch.float32: 1e-3, torch.bfloat16: 2 ** -7 + 1e-3}


@pytest.fixture(scope="module")
def hopper():
    """The card the kernels are built for; skips elsewhere (decided here, at
    run time, never at import)."""
    from accelerate_tpu_torch.utils.environment import on_hopper

    if not on_hopper():
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0) and nvcc")
    return torch.device("cuda")


def _near(got, want, tol=FP16_TOL, what=""):
    atol, rtol = tol
    assert got.dtype == want.dtype and got.shape == want.shape, what
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol, msg=what)


FLASH_CASES = {
    "causal_d64_s1000": dict(causal=True, d=64, sq=1000, skv=1000),
    "full_d128_s300": dict(causal=False, d=128, sq=300, skv=300),
    "cross_causal_d64": dict(causal=True, d=64, sq=100, skv=130),
    "causal_d192": dict(causal=True, d=192, sq=200, skv=200),
    "causal_d320": dict(causal=True, d=320, sq=130, skv=130),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_fp16_flash_kernels_match_plain(hopper, name):
    spec = FLASH_CASES[name]
    g = torch.Generator(device=hopper).manual_seed(0)
    d, causal = spec["d"], spec["causal"]
    q = (torch.randn(2, 3, spec["sq"], d, generator=g, device=hopper) / d ** 0.5).half()
    k, v = (torch.randn(2, 3, spec["skv"], d, generator=g, device=hopper).half() for _ in range(2))
    do = torch.randn(2, 3, spec["sq"], d, generator=g, device=hopper).half()
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    o_ref, lse_ref = fa.flash_attention_forward_reference(q, k, v, causal)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fa.flash_attention_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(n + 1 for n in before)
    _near(o, o_ref, what="o")
    assert (lse - lse_ref).abs().max().item() <= LSE_ATOL
    _near(dq, fa.flash_attention_dq_reference(q, k, v, do, lse_ref, delta, causal), what="dq")
    for what, got, want in zip(("dk", "dv"), (dk, dv),
                               fa.flash_attention_dkv_reference(q, k, v, do, lse_ref, delta, causal)):
        _near(got, want, what=what)


@pytest.mark.parametrize("window,hq,hkv,s", [(200, 8, 2, 700), (None, 4, 4, 300), (33, 4, 1, 257)])
def test_fp16_band_kernels_match_plain(hopper, window, hq, hkv, s):
    g = torch.Generator(device=hopper).manual_seed(1)
    q = (torch.randn(1, hq, s, 128, generator=g, device=hopper) / 128 ** 0.5).half()
    k, v = (torch.randn(1, hkv, s, 128, generator=g, device=hopper).half() for _ in range(2))
    do = torch.randn(1, hq, s, 128, generator=g, device=hopper).half()
    o_ref, lse_ref = fa.flash_band_forward_reference(q, k, v, window)
    o, lse = fa.flash_band_fwd(q, k, v, window)
    delta = (do.float() * o_ref.float()).sum(-1)
    _near(o, o_ref, what="o")
    assert (lse - lse_ref).abs().max().item() <= LSE_ATOL
    _near(fa.flash_band_dq(q, k, v, do, lse_ref, delta, window),
          fa.flash_band_dq_reference(q, k, v, do, lse_ref, delta, window), what="dq")
    for what, got, want in zip(("dk", "dv"), fa.flash_band_dkv(q, k, v, do, lse_ref, delta, window),
                               fa.flash_band_dkv_reference(q, k, v, do, lse_ref, delta, window)):
        _near(got, want, what=what)


@pytest.mark.parametrize("n,v,e,ignore_all", [(1000, 5003, 768, False), (64, 100, 40, False),
                                              (128, 300, 64, True)])
def test_fp16_fused_ce_kernels_match_plain(hopper, n, v, e, ignore_all):
    g = torch.Generator(device=hopper).manual_seed(2)
    h = torch.randn(n, e, generator=g, device=hopper).half()
    w = (torch.randn(v, e, generator=g, device=hopper) * 0.02).half()
    labels = torch.randint(0, v, (n,), generator=g, device=hopper).to(torch.int32)
    g_lse = torch.full((n,), 0.0 if ignore_all else 1.0 / n, device=hopper)
    args = (h, w, labels)
    lse, ll = fc.fused_ce_fwd(*args)
    lse_ref, ll_ref = fc.fused_ce_forward_reference(*args)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(ll, ll_ref, atol=1e-4, rtol=1e-5)
    bwd = (*args, lse_ref, g_lse, -g_lse)
    dh, dw = fc.fused_ce_dh(*bwd), fc.fused_ce_dw(*bwd)
    if ignore_all:
        assert not dh.any() and not dw.any()
    for what, got, want in (("dh", dh, fc.fused_ce_dh_reference(*bwd)),
                            ("dw", dw, fc.fused_ce_dw_reference(*bwd))):
        scale = want.float().abs().max().item() or 1.0
        _near(got, want, tol=(FP16_TOL[0] * scale, FP16_TOL[1]), what=what)


@pytest.mark.parametrize("a_dtype,b_dtype", [(fp8.E4M3, fp8.E4M3), (fp8.E5M2, fp8.E4M3),
                                             (fp8.E4M3, fp8.E5M2)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fp8_gemm_matches_the_fp32_product(hopper, a_dtype, b_dtype, out_dtype):
    """The forward pair (e4m3 x e4m3), dX's (e5m2 x e4m3) and dK's (e4m3 x
    e5m2), b column-major as the forward gives it and row-major (the wrapper
    transposes it)."""
    g = torch.Generator(device=hopper).manual_seed(3)
    x = torch.randn(256, 768, generator=g, device=hopper)
    k = torch.randn(768, 512, generator=g, device=hopper) * 0.05
    fmax = {fp8.E4M3: fp8.E4M3_MAX, fp8.E5M2: fp8.E5M2_MAX}
    sa, sb = torch.tensor(10.0, device=hopper), torch.tensor(100.0, device=hopper)
    a = fp8.quantize(x, sa, a_dtype, fmax[a_dtype])
    for b in (fp8.quantize(k.T.contiguous().T, sb, b_dtype, fmax[b_dtype]),
              fp8.quantize(k, sb, b_dtype, fmax[b_dtype])):
        calls = fp8.fp8_gemm.calls
        got = fp8.fp8_gemm(a, b, sa, sb, out_dtype)
        want = fp8.fp8_gemm_reference(a, b, sa, sb, torch.float32)
        assert got.dtype == out_dtype and fp8.fp8_gemm.calls == calls + 1
        err = (got.float() - want).abs().max().item()
        assert err <= GEMM_RTOL[out_dtype] * want.abs().max().item(), err
    with pytest.raises(ValueError, match="multiples of 16"):
        fp8.fp8_gemm(a[:, :760], b[:760], sa, sb, out_dtype)


def test_fp8_linear_on_the_card_matches_the_cpu(hopper):
    """Three training calls at GPT-2's ``up`` shape, bf16 compute, one
    cotangent for both: output, input and weight gradients, and the scaling
    state after each."""
    recipe = fp8.DelayedScalingRecipe()
    cpu = fp8.Fp8Linear(768, 3072, recipe=recipe, device="cpu")
    card = fp8.Fp8Linear(768, 3072, recipe=recipe, device=hopper)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(4)
    for _ in range(3):
        x = torch.randn(4, 64, 768, generator=gen)
        xa, xb = x.clone().requires_grad_(), x.to(hopper).requires_grad_()
        ya, yb = cpu(xa, torch.bfloat16), card(xb, torch.bfloat16)
        # one cotangent for both: a cotangent made from each side's own
        # output would differ by bf16 rounding and cross e5m2 boundaries
        g = (torch.randn(4, 64, 3072, generator=gen) * 1e-3).to(torch.bfloat16)
        ya.backward(g)
        yb.backward(g.to(hopper))
        for what, a, b in (("out", ya, yb), ("dx", xa.grad, xb.grad),
                           ("dw", cpu.weight.grad, card.weight.grad)):
            err = (a.float() - b.cpu().float()).abs().max().item()
            assert err <= GEMM_RTOL[torch.bfloat16] * a.float().abs().max().item(), (what, err)
        cpu.weight.grad = card.weight.grad = None
        for name, t in cpu.named_buffers():
            torch.testing.assert_close(dict(card.named_buffers())[name].cpu(), t, rtol=1e-6,
                                       atol=0, msg=name)


def _train(hopper, mixed, steps=4, **cfg):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn_pallas

    dtype = torch.float16 if mixed == "fp16" else torch.bfloat16
    model = GPT2LMHead(GPT2Config.tiny(dtype=dtype, attention_impl="flash", **cfg),
                       device=hopper, seed=0)
    acc = Accelerator(mixed_precision=mixed, device=hopper)
    opt = (fp8.adamw_fp8(model.parameters(), 1e-3, opt_level="O2") if mixed == "fp8"
           else torch.optim.AdamW(model.parameters(), lr=1e-3))
    model, opt = acc.prepare(model, opt)
    step = acc.make_train_step(lm_loss_fn_pallas)
    g = torch.Generator(device=hopper).manual_seed(5)
    ids = torch.randint(0, 256, (4, 64), generator=g, device=hopper)
    return [step({"input_ids": ids}).item() for _ in range(steps)], model


def test_fp16_flash_fused_loss_trains_on_the_card(hopper):
    counts = (fa.flash_attention_fwd.launches, fc.fused_ce_fwd.launches, fc.fused_ce_dw.launches)
    losses, _ = _train(hopper, "fp16")
    assert all(map(torch.isfinite, torch.tensor(losses))) and losses[-1] < losses[0]
    after = (fa.flash_attention_fwd.launches, fc.fused_ce_fwd.launches, fc.fused_ce_dw.launches)
    assert [b - a for a, b in zip(counts, after)] == [4 * 2, 4, 4]


@pytest.mark.parametrize("policy", [None, "dots"])
def test_fp8_o2_trains_on_the_card_under_remat(hopper, policy):
    """Four fp8 O2 steps, with and without remat: the same losses (the
    recompute replays the forward's scales) and one history entry a step."""
    base, model = _train(hopper, "fp8", fp8_recipe=fp8.DelayedScalingRecipe())
    got, model_r = _train(hopper, "fp8", fp8_recipe=fp8.DelayedScalingRecipe(), remat=True,
                          remat_policy=policy)
    assert losses_close(base, got) and base[-1] < base[0]
    for (name, a), b in zip(model.module.named_buffers(), model_r.module.buffers()):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=0, msg=name)
    assert (model.module.blocks[0].mlp.up.input_amax_history > 0).sum().item() == 4


def losses_close(a, b, atol=1e-4):
    return all(abs(x - y) <= atol for x, y in zip(a, b))
