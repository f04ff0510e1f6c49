"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA Hopper GPU and nvcc, and skips elsewhere. The
file imports nothing of JAX, so it runs on a machine without it (the repo's
conftest imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from accelerate_tpu_torch.ops.attention import dot_product_attention
from accelerate_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_dkv,
    flash_attention_dkv_reference,
    flash_attention_dq,
    flash_attention_dq_reference,
    flash_attention_forward_reference,
    flash_attention_fwd,
    flash_band_dkv,
    flash_band_dkv_reference,
    flash_band_dq,
    flash_band_dq_reference,
    flash_band_forward_reference,
    flash_band_fwd,
    paged_decode_attention,
    paged_decode_attention_reference,
)

pytestmark = pytest.mark.cuda

# by query dtype: fp32 differs only in summation order; a bf16/fp16 output is
# rounded once by the kernel but twice (softmax weights, then the product) by
# the plain version
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}

CASES = {
    "fp32_ragged_empty": dict(dtype=torch.float32, hq=4, kvh=4, d=64, lengths=[0, 1, 16, 17, 200]),
    "bf16_parked": dict(dtype=torch.bfloat16, hq=4, kvh=4, d=64, lengths=[5, 64, 33, 40],
                        parked=(3,)),
    "fp16_gqa4_d128": dict(dtype=torch.float16, hq=8, kvh=2, d=128, lengths=[9, 100, 255]),
    "bf16_gqa8": dict(dtype=torch.bfloat16, hq=16, kvh=2, d=64, lengths=[31, 1, 128]),
    "int8_fp32q": dict(dtype=torch.float32, hq=2, kvh=2, d=64, lengths=[3, 48, 250], quant=True),
    "int8_bf16q_gqa2": dict(dtype=torch.bfloat16, hq=4, kvh=2, d=128, lengths=[70, 7], quant=True,
                            parked=(1,)),
    # the general body: head_dims off 64 and 128 (16-, 4- and 2-byte row
    # pieces) and group counts off 1, 2, 4 and 8 (16: two chunks of 8)
    "bf16_d32": dict(dtype=torch.bfloat16, hq=4, kvh=4, d=32, lengths=[5, 64, 33, 40], parked=(3,)),
    "bf16_gqa3": dict(dtype=torch.bfloat16, hq=6, kvh=2, d=64, lengths=[5, 64, 33, 40], parked=(3,)),
    "fp32_d40_gqa2": dict(dtype=torch.float32, hq=4, kvh=2, d=40, lengths=[0, 17, 200]),
    "bf16_d96_gqa6": dict(dtype=torch.bfloat16, hq=12, kvh=2, d=96, lengths=[9, 100, 255]),
    "bf16_d256": dict(dtype=torch.bfloat16, hq=4, kvh=4, d=256, lengths=[1, 130, 256]),
    "fp16_gqa16_d128": dict(dtype=torch.float16, hq=16, kvh=1, d=128, lengths=[31, 250]),
    "bf16_d33": dict(dtype=torch.bfloat16, hq=2, kvh=1, d=33, lengths=[40, 3, 0]),
    "int8_bf16q_d96_gqa3": dict(dtype=torch.bfloat16, hq=6, kvh=2, d=96, lengths=[70, 7],
                                quant=True),
    "int8_fp32q_d36": dict(dtype=torch.float32, hq=2, kvh=2, d=36, lengths=[3, 250], quant=True),
}


@pytest.fixture
def hopper():
    """The card the kernels are built for; skips elsewhere (decided here, at
    run time, never at import)."""
    from accelerate_tpu_torch.utils.environment import on_hopper

    if not on_hopper():
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0) and nvcc")
    return torch.device("cuda")


def _inputs(dev, *, dtype, hq, kvh, d, lengths, quant=False, parked=(), bt=16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, bps = len(lengths), 16
    nb = b * bps + 2
    shape = (nb, bt, kvh, d)
    scales = {}
    if quant:
        k = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        scales = {"k_scale_pool": torch.rand(shape[:3], generator=g, device=dev) * 0.02,
                  "v_scale_pool": torch.rand(shape[:3], generator=g, device=dev) * 0.02}
    else:
        k = torch.randn(shape, generator=g, device=dev).to(dtype)
        v = torch.randn(shape, generator=g, device=dev).to(dtype)
    tables = torch.randperm(nb, generator=g, device=dev)[: b * bps].reshape(b, bps).int()
    for i, n in enumerate(lengths):
        tables[i, -(-n // bt):] = nb  # unreserved entries: the sentinel id
    for i in parked:
        tables[i] = nb
    q = torch.randn(b, hq, d, generator=g, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q, k, v, tables, lens), scales


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_decode_kernel_matches_plain(hopper, name):
    args, scales = _inputs(hopper, **CASES[name])
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args, **scales)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_reference(*args, **scales)
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[args[0].dtype], rtol=0)
    for i, n in enumerate(CASES[name]["lengths"]):
        if n <= 0:
            assert not out[i].any()


@pytest.mark.parametrize("change,exc", [
    (dict(dtype=torch.float64), TypeError),
])
def test_paged_decode_kernel_rejects_what_it_does_not_take(hopper, change, exc):
    spec = {**CASES["bf16_parked"], **change}
    args, _ = _inputs(hopper, **spec)
    with pytest.raises(exc):
        paged_decode_attention(*args)


@pytest.mark.parametrize("name", ["bf16_parked", "bf16_d96_gqa6", "int8_bf16q_gqa2"])
def test_paged_decode_kernel_gives_equal_bits_twice(hopper, name):
    """A row's splits are merged in split order with no atomics: two launches
    on one input agree to the bit."""
    args, scales = _inputs(hopper, **CASES[name])
    first, second = (paged_decode_attention(*args, **scales) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _graph_replays_like_eager(fn, refill):
    """Capture ``fn()`` in a CUDA graph after an eager warm-up (the build, the
    library load, the nf4 plane pack), replay it, then refill its inputs in
    place and replay again: each replay equals an eager call on the inputs
    of the moment, to the bit."""
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    refill()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, fn())


def test_paged_decode_kernel_replays_from_a_cuda_graph(hopper):
    args, scales = _inputs(hopper, **CASES["int8_bf16q_gqa2"])
    q, lens = args[0], args[4]
    before = paged_decode_attention.launches

    def refill():
        q.copy_(torch.randn_like(q.float()).to(q.dtype))
        lens.copy_(torch.tensor([33, 200], dtype=torch.int32, device=hopper))

    _graph_replays_like_eager(lambda: paged_decode_attention(*args, **scales), refill)
    assert paged_decode_attention.launches > before


def test_paged_decode_kernel_rejects_a_strided_pool(hopper):
    (q, k, v, tables, lens), _ = _inputs(hopper, **CASES["bf16_parked"])
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(q, k[::2], v[::2], tables // 2, lens)


# flash attention kernels against their plain versions. fp32: summation order
# over up to 1024 terms; bf16: p and dS are rounded to bf16 before products and
# a value near a rounding boundary may round the other way, then the output is
# rounded once more, so the bar is relative (|err| <= atol + rtol * |ref|)
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# lse of the forward kernels, absolute, every dtype: both sides sum the same
# fp32 scores (the bf16 kernel in base 2, exp2 of log2e-scaled scores) in
# another order, so they agree to a few fp32 ulps of the row's magnitude; the
# backward kernels recompute p from this lse, so it is held far tighter than
# the outputs
LSE_ATOL = 1e-4

FLASH_CASES = {
    "bf16_causal_d64": dict(dtype=torch.bfloat16, causal=True, d=64, sq=256, skv=256),
    "fp32_causal_d64": dict(dtype=torch.float32, causal=True, d=64, sq=256, skv=256),
    "bf16_full_d128": dict(dtype=torch.bfloat16, causal=False, d=128, sq=192, skv=192),
    "fp32_full_d128": dict(dtype=torch.float32, causal=False, d=128, sq=160, skv=160),
    "bf16_causal_ragged": dict(dtype=torch.bfloat16, causal=True, d=64, sq=200, skv=200),
    "fp32_causal_d128_ragged": dict(dtype=torch.float32, causal=True, d=128, sq=77, skv=77),
    "bf16_cross_ragged": dict(dtype=torch.bfloat16, causal=True, d=64, sq=100, skv=130),
    "fp32_cross_full": dict(dtype=torch.float32, causal=False, d=64, sq=70, skv=33),
    # the bf16 forward's edges: 128-row q tiles of two 64-row warpgroups,
    # 128-row kv tiles loaded by TMA (zero-filled past the end, then masked)
    "bf16_causal_s129": dict(dtype=torch.bfloat16, causal=True, d=64, sq=129, skv=129),
    "bf16_full_s191": dict(dtype=torch.bfloat16, causal=False, d=64, sq=191, skv=191),
    "bf16_causal_s1000": dict(dtype=torch.bfloat16, causal=True, d=64, sq=1000, skv=1000),
    "bf16_causal_d128_ragged": dict(dtype=torch.bfloat16, causal=True, d=128, sq=191, skv=191),
    "bf16_sq1_causal": dict(dtype=torch.bfloat16, causal=True, d=64, sq=1, skv=1),
    "bf16_sq1_cross_full_d128": dict(dtype=torch.bfloat16, causal=False, d=128, sq=1, skv=130),
    "bf16_cross_causal_d128": dict(dtype=torch.bfloat16, causal=True, d=128, sq=129, skv=300),
    # the bf16 dK/dV's edges: many q tiles through its Q/dO ring, and keys
    # past a ragged query range without the causal mask
    "bf16_causal_s2048_d128": dict(dtype=torch.bfloat16, causal=True, d=128, sq=2048, skv=2048),
    "bf16_cross_full_sq70_skv333": dict(dtype=torch.bfloat16, causal=False, d=64, sq=70, skv=333),
    # the bf16 dQ's edges: fewer keys than queries, with a ragged kv tile
    # under three q tiles of its own
    "bf16_cross_full_sq333_skv70": dict(dtype=torch.bfloat16, causal=False, d=64, sq=333, skv=70),
    # head_dim 192 and 256 (the scalar bodies in both types, 32 x 32 tiles):
    # ragged ends, cross lengths, causal and not
    "bf16_causal_d192": dict(dtype=torch.bfloat16, causal=True, d=192, sq=200, skv=200),
    "fp32_full_d192_cross": dict(dtype=torch.float32, causal=False, d=192, sq=70, skv=129),
    "bf16_causal_d256": dict(dtype=torch.bfloat16, causal=True, d=256, sq=257, skv=257),
    "bf16_full_d256_cross": dict(dtype=torch.bfloat16, causal=False, d=256, sq=129, skv=45),
    "fp32_causal_d256_ragged": dict(dtype=torch.float32, causal=True, d=256, sq=77, skv=77),
    # every head_dim above 256 (the run-time head_dim body: 32 x 32 tiles,
    # d in chunks of 64, accumulators in the workspace): 320, 384 (what 300
    # pads to), 512 and 640, both types, ragged ends, cross lengths
    "bf16_causal_d320": dict(dtype=torch.bfloat16, causal=True, d=320, sq=200, skv=200),
    "fp32_full_d320_cross": dict(dtype=torch.float32, causal=False, d=320, sq=70, skv=129),
    "bf16_full_d384_cross": dict(dtype=torch.bfloat16, causal=False, d=384, sq=129, skv=45),
    "fp32_causal_d384_ragged": dict(dtype=torch.float32, causal=True, d=384, sq=77, skv=77),
    "bf16_causal_d512": dict(dtype=torch.bfloat16, causal=True, d=512, sq=257, skv=257),
    "fp32_causal_d512_cross": dict(dtype=torch.float32, causal=True, d=512, sq=33, skv=100),
    "bf16_full_d640": dict(dtype=torch.bfloat16, causal=False, d=640, sq=96, skv=96),
    "fp32_causal_d640_ragged": dict(dtype=torch.float32, causal=True, d=640, sq=130, skv=130),
}


def _flash_inputs(dev, *, dtype, causal, d, sq, skv, b=2, h=3, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h, sq, d, generator=g, device=dev) / d ** 0.5).to(dtype)
    k = torch.randn(b, h, skv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, h, skv, d, generator=g, device=dev).to(dtype)
    dout = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    return q, k, v, dout


def _assert_near(got, want, dtype):
    atol, rtol = FLASH_TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(hopper, name):
    spec = FLASH_CASES[name]
    causal, dtype = spec["causal"], spec["dtype"]
    q, k, v, dout = _flash_inputs(hopper, **spec)
    o_ref, lse_ref = flash_attention_forward_reference(q, k, v, causal)
    before = (flash_attention_fwd.launches, flash_attention_dq.launches, flash_attention_dkv.launches)
    o, lse = flash_attention_fwd(q, k, v, causal)
    delta = (dout.float() * o_ref.float()).sum(-1)
    dq = flash_attention_dq(q, k, v, dout, lse_ref, delta, causal)
    dk, dv = flash_attention_dkv(q, k, v, dout, lse_ref, delta, causal)
    torch.cuda.synchronize()
    after = (flash_attention_fwd.launches, flash_attention_dq.launches, flash_attention_dkv.launches)
    assert after == tuple(n + 1 for n in before)
    _assert_near(o, o_ref, dtype)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)
    _assert_near(dq, flash_attention_dq_reference(q, k, v, dout, lse_ref, delta, causal), dtype)
    dk_ref, dv_ref = flash_attention_dkv_reference(q, k, v, dout, lse_ref, delta, causal)
    _assert_near(dk, dk_ref, dtype)
    _assert_near(dv, dv_ref, dtype)


@pytest.mark.parametrize("d,hq,hk", [(64, 4, 4), (40, 4, 2), (136, 4, 2), (192, 2, 2),
                                    (300, 2, 1)])
def test_flash_attention_grads_match_plain_attention(hopper, d, hq, hk):
    """The public BSHD wrapper on the card (pre-scale, head-dim padding, GQA
    repeat, the autograd.Function) against autograd through the plain path,
    in fp32 (TF32 off)."""
    g = torch.Generator(device=hopper).manual_seed(1)
    q = torch.randn(2, 130, hq, d, generator=g, device=hopper, requires_grad=True)
    k = torch.randn(2, 130, hk, d, generator=g, device=hopper, requires_grad=True)
    v = torch.randn(2, 130, hk, d, generator=g, device=hopper, requires_grad=True)
    ct = torch.randn(2, 130, hq, d, generator=g, device=hopper)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad((out * ct).sum(), (q, k, v))
        kr, vr = (t.repeat_interleave(hq // hk, dim=2) for t in (k, v))
        ref = dot_product_attention(q, kr, vr, causal=True)
        ref_grads = torch.autograd.grad((ref * ct).sum(), (q, k, v))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("change,exc", [
    (dict(d=32), ValueError),  # head_dim the kernel is not built for
    (dict(d=300), ValueError),  # above 256 but off a multiple of 64 (the wrapper pads it)
    (dict(dtype=torch.float64), TypeError),  # a dtype with no instance (fp16 has one)
])
def test_flash_kernel_rejects_what_it_does_not_take(hopper, change, exc):
    spec = {**FLASH_CASES["bf16_causal_d64"], **change}
    q, k, v, _ = _flash_inputs(hopper, **spec)
    with pytest.raises(exc):
        flash_attention_fwd(q, k, v, True)


def test_flash_kernels_reject_shapes_that_disagree(hopper):
    q, k, v, dout = _flash_inputs(hopper, **FLASH_CASES["bf16_causal_d64"])
    lse = torch.zeros(q.shape[:3], device=hopper)
    with pytest.raises(ValueError, match="one b, h and d"):
        flash_attention_fwd(q, k[:, :2], v[:, :2], True)  # unrepeated GQA heads
    with pytest.raises(ValueError, match="dO"):
        flash_attention_dq(q, k, v, dout[:, :, :-1], lse, lse, True)
    with pytest.raises(ValueError, match="lse and delta"):
        flash_attention_dkv(q, k, v, dout, lse[..., :-1], lse, True)


# band flash kernels (causal, or causal with a sliding window; GQA K/V
# unrepeated) against their plain versions, at FLASH_TOL
BAND_CASES = {
    "bf16_w100_gqa4_ragged": dict(dtype=torch.bfloat16, window=100, hq=8, hk=2, d=64, s=1000),
    "fp32_w100_gqa4_ragged": dict(dtype=torch.float32, window=100, hq=4, hk=1, d=64, s=1000),
    "bf16_triangle_d128": dict(dtype=torch.bfloat16, window=None, hq=4, hk=4, d=128, s=256),
    "fp32_triangle_gqa2_d128_ragged": dict(dtype=torch.float32, window=None, hq=4, hk=2, d=128,
                                           s=77),
    "bf16_w1_d128": dict(dtype=torch.bfloat16, window=1, hq=8, hk=8, d=128, s=512),
    "fp32_w_ge_seq_gqa2_d128": dict(dtype=torch.float32, window=2048, hq=4, hk=2, d=128, s=200),
    # the sliding-window example's kernel shape: fp32 at d 128 (its head_dim
    # 16 padded), a window well inside the sequence
    "fp32_w32_gqa2_d128_s128": dict(dtype=torch.float32, window=32, hq=4, hk=2, d=128, s=128),
    "bf16_w37_gqa8": dict(dtype=torch.bfloat16, window=37, hq=8, hk=1, d=64, s=300),
    # the bf16 forward's edges: windows that cut a 128-row tile, ragged ends,
    # s = 1, GQA groups 4 and 8 under a window at both head dims
    "bf16_w65_s191": dict(dtype=torch.bfloat16, window=65, hq=4, hk=4, d=64, s=191),
    "bf16_w129_gqa4_d128": dict(dtype=torch.bfloat16, window=129, hq=8, hk=2, d=128, s=1000),
    "bf16_w100_gqa8_d128_s129": dict(dtype=torch.bfloat16, window=100, hq=8, hk=1, d=128, s=129),
    "bf16_w65_gqa4_s1000": dict(dtype=torch.bfloat16, window=65, hq=4, hk=1, d=64, s=1000),
    "bf16_triangle_d128_s129": dict(dtype=torch.bfloat16, window=None, hq=4, hk=2, d=128, s=129),
    "bf16_s1_triangle": dict(dtype=torch.bfloat16, window=None, hq=4, hk=4, d=64, s=1),
    # the bf16 dK/dV's edges: kv tiles whose q ranges end inside the sequence
    # and a ring that wraps across the group loop; window 1 at d 64
    "bf16_w4096_gqa8_d128_s4500": dict(dtype=torch.bfloat16, window=4096, hq=8, hk=1, d=128,
                                       s=4500, b=1),
    "bf16_w1_d64": dict(dtype=torch.bfloat16, window=1, hq=4, hk=4, d=64, s=300),
    # the bf16 dQ's edges: a window that starts inside a kv tile of its K/V
    # ring, at d 128 with GQA 8
    "bf16_w200_gqa8_d128_s700": dict(dtype=torch.bfloat16, window=200, hq=8, hk=1, d=128, s=700),
    # head_dim 192 and 256 (the scalar bodies, 32 x 32 tiles): windows that
    # cut tiles, GQA, ragged ends
    "bf16_w100_gqa4_d192": dict(dtype=torch.bfloat16, window=100, hq=8, hk=2, d=192, s=300),
    "fp32_triangle_gqa2_d192_ragged": dict(dtype=torch.float32, window=None, hq=4, hk=2, d=192,
                                           s=77),
    "bf16_w65_gqa2_d256": dict(dtype=torch.bfloat16, window=65, hq=4, hk=2, d=256, s=333),
    "fp32_w37_d256": dict(dtype=torch.float32, window=37, hq=2, hk=2, d=256, s=130),
    "bf16_triangle_d256_s129": dict(dtype=torch.bfloat16, window=None, hq=4, hk=4, d=256, s=129),
    # above 256 (the run-time head_dim body): windows that cut tiles, GQA,
    # ragged ends, both types
    "bf16_w100_gqa4_d320": dict(dtype=torch.bfloat16, window=100, hq=8, hk=2, d=320, s=300),
    "fp32_triangle_gqa2_d320_ragged": dict(dtype=torch.float32, window=None, hq=4, hk=2, d=320,
                                           s=77),
    "bf16_w65_gqa2_d384": dict(dtype=torch.bfloat16, window=65, hq=4, hk=2, d=384, s=200),
    "fp32_w37_d384": dict(dtype=torch.float32, window=37, hq=2, hk=2, d=384, s=130),
    "bf16_triangle_d512_s129": dict(dtype=torch.bfloat16, window=None, hq=4, hk=4, d=512, s=129),
    "fp32_w50_gqa4_d512": dict(dtype=torch.float32, window=50, hq=4, hk=1, d=512, s=100),
    "bf16_w33_gqa2_d640": dict(dtype=torch.bfloat16, window=33, hq=4, hk=2, d=640, s=97),
    "fp32_triangle_d640": dict(dtype=torch.float32, window=None, hq=2, hk=2, d=640, s=64),
}


def _band_inputs(dev, *, dtype, window, hq, hk, d, s, b=2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, hq, s, d, generator=g, device=dev) / d ** 0.5).to(dtype)
    k = torch.randn(b, hk, s, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, hk, s, d, generator=g, device=dev).to(dtype)
    dout = torch.randn(b, hq, s, d, generator=g, device=dev).to(dtype)
    return q, k, v, dout


@pytest.mark.parametrize("name", sorted(BAND_CASES))
def test_band_kernels_match_plain(hopper, name):
    spec = BAND_CASES[name]
    window, dtype = spec["window"], spec["dtype"]
    q, k, v, dout = _band_inputs(hopper, **spec)
    o_ref, lse_ref = flash_band_forward_reference(q, k, v, window)
    delta = (dout.float() * o_ref.float()).sum(-1)
    before = (flash_band_fwd.launches, flash_band_dq.launches, flash_band_dkv.launches)
    o, lse = flash_band_fwd(q, k, v, window)
    dq = flash_band_dq(q, k, v, dout, lse_ref, delta, window)
    dk, dv = flash_band_dkv(q, k, v, dout, lse_ref, delta, window)
    torch.cuda.synchronize()
    after = (flash_band_fwd.launches, flash_band_dq.launches, flash_band_dkv.launches)
    assert after == tuple(n + 1 for n in before)
    _assert_near(o, o_ref, dtype)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)
    _assert_near(dq, flash_band_dq_reference(q, k, v, dout, lse_ref, delta, window), dtype)
    dk_ref, dv_ref = flash_band_dkv_reference(q, k, v, dout, lse_ref, delta, window)
    assert dk.shape == k.shape and dv.shape == v.shape  # kv-head shape
    _assert_near(dk, dk_ref, dtype)
    _assert_near(dv, dv_ref, dtype)


@pytest.mark.parametrize("band", [False, True])
def test_dkv_kernels_give_equal_bits_twice(hopper, band):
    """dK/dV sum in a fixed order with no atomics: two launches on one input
    agree to the bit."""
    if band:
        q, k, v, dout = _band_inputs(hopper, **BAND_CASES["bf16_w129_gqa4_d128"])
        o, lse = flash_band_forward_reference(q, k, v, 129)
        args = (q, k, v, dout, lse, (dout.float() * o.float()).sum(-1), 129)
        first, second = flash_band_dkv(*args), flash_band_dkv(*args)
    else:
        q, k, v, dout = _flash_inputs(hopper, **FLASH_CASES["bf16_causal_s1000"])
        o, lse = flash_attention_forward_reference(q, k, v, True)
        args = (q, k, v, dout, lse, (dout.float() * o.float()).sum(-1), True)
        first, second = flash_attention_dkv(*args), flash_attention_dkv(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("band", [False, True])
def test_dq_kernels_give_equal_bits_twice(hopper, band):
    """dQ sums over kv tiles in a fixed order with no atomics: two launches on
    one input agree to the bit."""
    if band:
        q, k, v, dout = _band_inputs(hopper, **BAND_CASES["bf16_w200_gqa8_d128_s700"])
        o, lse = flash_band_forward_reference(q, k, v, 200)
        args = (q, k, v, dout, lse, (dout.float() * o.float()).sum(-1), 200)
        first, second = flash_band_dq(*args), flash_band_dq(*args)
    else:
        q, k, v, dout = _flash_inputs(hopper, **FLASH_CASES["bf16_causal_s1000"])
        o, lse = flash_attention_forward_reference(q, k, v, True)
        args = (q, k, v, dout, lse, (dout.float() * o.float()).sum(-1), True)
        first, second = flash_attention_dq(*args), flash_attention_dq(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("window,hq,hk", [(48, 4, 2), (None, 4, 1)])
def test_band_flash_attention_grads_match_plain_attention(hopper, window, hq, hk):
    """The public BSHD wrapper on the band route (pre-scale, `_FlashBand`,
    GQA K/V unrepeated, a ragged 130) against autograd through the plain
    windowed path, in fp32 (TF32 off)."""
    g = torch.Generator(device=hopper).manual_seed(2)
    q = torch.randn(2, 130, hq, 64, generator=g, device=hopper, requires_grad=True)
    k = torch.randn(2, 130, hk, 64, generator=g, device=hopper, requires_grad=True)
    v = torch.randn(2, 130, hk, 64, generator=g, device=hopper, requires_grad=True)
    ct = torch.randn(2, 130, hq, 64, generator=g, device=hopper)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = flash_band_fwd.launches
        out = flash_attention(q, k, v, causal=True, window=window, triangle_block=10)
        assert flash_band_fwd.launches == before + 1
        grads = torch.autograd.grad((out * ct).sum(), (q, k, v))
        kr, vr = (t.repeat_interleave(hq // hk, dim=2) for t in (k, v))
        ref = dot_product_attention(q, kr, vr, causal=True, window=window)
        ref_grads = torch.autograd.grad((ref * ct).sum(), (q, k, v))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    for got, want in zip(grads, ref_grads):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("change,exc", [
    (dict(d=32), ValueError),  # head_dim the kernel is not built for
    (dict(d=300), ValueError),  # above 256 but off a multiple of 64 (the wrapper pads it)
    (dict(dtype=torch.float64), TypeError),  # a dtype with no instance (fp16 has one)
    (dict(hq=6, hk=4), ValueError),  # query heads not a multiple of kv heads
])
def test_band_kernel_rejects_what_it_does_not_take(hopper, change, exc):
    spec = {**BAND_CASES["bf16_w37_gqa8"], **change}
    q, k, v, _ = _band_inputs(hopper, **spec)
    with pytest.raises(exc):
        flash_band_fwd(q, k, v, spec["window"])


# fused LM head + cross-entropy kernels against their plain versions. Both
# sides take the same fp32 logits from the same operands in another summation
# order; the bar is |err| <= rtol * |plain| + atol * max|plain|. fp32: order
# only. bf16: dlogits are rounded to bf16 before the products (a value near a
# rounding boundary may round the other way) and each output is rounded once.
FUSED_CE_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-3)}

FUSED_CE_CASES = {
    "bf16_e768_ragged": dict(dtype=torch.bfloat16, n=300, v=1000, e=768),
    "fp32_e768_ragged": dict(dtype=torch.float32, n=77, v=517, e=768),
    "bf16_e1024": dict(dtype=torch.bfloat16, n=256, v=640, e=1024),
    "fp32_e1024_ragged": dict(dtype=torch.float32, n=129, v=333, e=1024),
    "bf16_e1280_split": dict(dtype=torch.bfloat16, n=100, v=300, e=1280),
    "fp32_e64_tiny": dict(dtype=torch.float32, n=5, v=3, e=64),
    # the bf16 backward's own edges: one slice whose warpgroups hold 3 and 2
    # output chunks; 8 slices of e; three own tiles, so a cluster runs a
    # padding tile; one vocab entry (and e 128, fewer chunks than ring
    # stages). With one entry p is 1 and the loss's g_ll = -g_lse gives a
    # gradient of exactly 0, so the bar would be 0 and an ulp of p between
    # two summation orders of the logit would fail it: that case takes
    # g_ll = -g_lse / 2
    "bf16_e320": dict(dtype=torch.bfloat16, n=200, v=700, e=320),
    "bf16_e4096": dict(dtype=torch.bfloat16, n=130, v=300, e=4096),
    "bf16_n130": dict(dtype=torch.bfloat16, n=130, v=150, e=768),
    "bf16_v1": dict(dtype=torch.bfloat16, n=64, v=1, e=128, g_ll_scale=0.5),
    # a width off the kernels' 64-column chunk: the wrappers zero-pad e
    "bf16_e96": dict(dtype=torch.bfloat16, n=100, v=300, e=96),
    "fp32_e40": dict(dtype=torch.float32, n=33, v=70, e=40),
    # the bf16 forward's vocab split (`fused_ce.fwd_plan`): one row and one
    # row tile split 8 and 16 ways; a vocabulary inside one vocab tile (one
    # split); 17 vocab tiles over 16 splits of 2, so the last splits hold
    # none and merge an empty state; every label the last vocab entry
    "bf16_n1": dict(dtype=torch.bfloat16, n=1, v=1000, e=768),
    "bf16_n64": dict(dtype=torch.bfloat16, n=64, v=5000, e=768),
    "bf16_v100": dict(dtype=torch.bfloat16, n=300, v=100, e=768),
    "bf16_empty_splits": dict(dtype=torch.bfloat16, n=1, v=17 * 128 - 5, e=256),
    "bf16_label_last": dict(dtype=torch.bfloat16, n=300, v=1000, e=768, label=-1),
}


def _fused_ce_inputs(dev, *, dtype, n, v, e, seed=0, g_ll_scale=1.0, label=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, e, generator=g, device=dev).to(dtype)
    w = (torch.randn(v, e, generator=g, device=dev) * 0.05).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    if label is not None:  # every row's label the vocab entry `label` (from the end if < 0)
        labels = torch.full_like(labels, label % v)
    mask = torch.arange(n, device=dev) % 8 != 3  # every eighth row ignored
    labels = torch.where(mask, labels, 0)
    g_lse = mask.float() / mask.sum()
    return h, w, labels, g_lse, -g_ll_scale * g_lse


def _assert_fused_near(got, want, dtype):
    rtol, atol = FUSED_CE_TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    bar = rtol * want.float().abs() + atol * want.float().abs().max()
    assert ((got.float() - want.float()).abs() <= bar).all(), (got.float() - want.float()).abs().max()


@pytest.mark.parametrize("name", sorted(FUSED_CE_CASES))
def test_fused_ce_kernels_match_plain(hopper, name):
    from accelerate_tpu_torch.ops import fused_ce as fc

    spec = FUSED_CE_CASES[name]
    h, w, labels, g_lse, g_ll = _fused_ce_inputs(hopper, **spec)
    before = (fc.fused_ce_fwd.launches, fc.fused_ce_dh.launches, fc.fused_ce_dw.launches)
    lse, ll = fc.fused_ce_fwd(h, w, labels)
    lse_ref, ll_ref = fc.fused_ce_forward_reference(h, w, labels)
    dh = fc.fused_ce_dh(h, w, labels, lse_ref, g_lse, g_ll)
    dw = fc.fused_ce_dw(h, w, labels, lse_ref, g_lse, g_ll)
    torch.cuda.synchronize()
    after = (fc.fused_ce_fwd.launches, fc.fused_ce_dh.launches, fc.fused_ce_dw.launches)
    assert after == tuple(k + 1 for k in before)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(ll, ll_ref, atol=1e-4, rtol=1e-5)
    _assert_fused_near(dh, fc.fused_ce_dh_reference(h, w, labels, lse_ref, g_lse, g_ll), spec["dtype"])
    _assert_fused_near(dw, fc.fused_ce_dw_reference(h, w, labels, lse_ref, g_lse, g_ll), spec["dtype"])


@pytest.mark.parametrize("kernel", ["dh", "dw"])
def test_fused_ce_bwd_kernels_give_equal_bits_twice(hopper, kernel):
    """dH and dW sum over the other tiles in a fixed order with no atomics:
    two launches on one input agree to the bit."""
    from accelerate_tpu_torch.ops import fused_ce as fc

    h, w, labels, g_lse, g_ll = _fused_ce_inputs(hopper, **FUSED_CE_CASES["bf16_e768_ragged"])
    lse, _ = fc.fused_ce_forward_reference(h, w, labels)
    fn = fc.fused_ce_dh if kernel == "dh" else fc.fused_ce_dw
    first, second = (fn(h, w, labels, lse, g_lse, g_ll) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fused_ce_fwd_gives_equal_bits_twice(hopper):
    """The bf16 forward merges its vocab splits in split order with no
    atomics: two launches on one input agree to the bit."""
    from accelerate_tpu_torch.ops import fused_ce as fc

    h, w, labels, _, _ = _fused_ce_inputs(hopper, **FUSED_CE_CASES["bf16_e768_ragged"])
    assert fc.fwd_plan(h.shape[0], w.shape[0], fc.card_limits(hopper.index or 0))["splits"] > 1
    first, second = (fc.fused_ce_fwd(h, w, labels) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("kernel", ["fwd", "dh", "dw"])
def test_fused_ce_kernels_replay_from_a_cuda_graph(hopper, kernel):
    """Each bf16 fused-CE C entry allocates nothing, never synchronises and
    sets its attributes once: a captured call replays like an eager one, to
    the bit, also after its inputs change in place."""
    from accelerate_tpu_torch.ops import fused_ce as fc

    h, w, labels, g_lse, g_ll = _fused_ce_inputs(hopper, **FUSED_CE_CASES["bf16_e768_ragged"])
    lse, _ = fc.fused_ce_forward_reference(h, w, labels)
    name = f"fused_ce_{kernel}"
    fn = getattr(fc, name)
    before = fn.launches
    if kernel == "fwd":
        def call():
            return torch.stack(fn(h, w, labels))
    else:
        def call():
            return fn(h, w, labels, lse, g_lse, g_ll)

    def refill():
        h.copy_(torch.randn_like(h.float()).to(h.dtype))
        labels.copy_(torch.randint_like(labels, w.shape[0]))

    _graph_replays_like_eager(call, refill)
    assert fn.launches > before


def test_fused_cross_entropy_all_ignored_on_the_card(hopper):
    from accelerate_tpu_torch.ops.fused_ce import fused_cross_entropy

    h, w, _, _, _ = _fused_ce_inputs(hopper, dtype=torch.bfloat16, n=64, v=200, e=128)
    h.requires_grad_()
    w.requires_grad_()
    loss = fused_cross_entropy(h, w, torch.full((64,), -100, device=hopper))
    loss.backward()
    assert loss.item() == 0.0
    assert not h.grad.any() and not w.grad.any()


@pytest.mark.parametrize("change,exc", [
    (dict(dtype=torch.float64), TypeError),  # a dtype with no instance (fp16 has one)
])
def test_fused_ce_kernel_rejects_what_it_does_not_take(hopper, change, exc):
    from accelerate_tpu_torch.ops import fused_ce as fc

    spec = {**FUSED_CE_CASES["bf16_e768_ragged"], **change}
    h, w, labels, _, _ = _fused_ce_inputs(hopper, **spec)
    with pytest.raises(exc):
        fc.fused_ce_fwd(h, w, labels)


# nf4 dequant-matmul against its plain version: both sum the same fp32
# products of the same dequantized weights in another order (split-K partials,
# warp partials), so fp32 agrees to a few ulps of the row's magnitude; bf16
# and fp16 outputs are rounded once from those fp32 sums (2^-8 relative for
# bf16), and a sum near a rounding boundary may round the other way
NF4_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2), torch.float16: (1e-3, 1e-3)}
NF4_CASES = {
    "m1_k4096_n4096_bf16": dict(M=1, K=4096, N=4096, dtype=torch.bfloat16),
    "m16_k768_n2304_bf16": dict(M=16, K=768, N=2304, dtype=torch.bfloat16),
    "m16_k3072_n768_fp32": dict(M=16, K=3072, N=768, dtype=torch.float32),
    "m5_k100_n256_fp16": dict(M=5, K=100, N=256, dtype=torch.float16),
    "m3_k768_n384_fp32": dict(M=3, K=768, N=384, dtype=torch.float32),
    "m200_k768_n768_bf16": dict(M=200, K=768, N=768, dtype=torch.bfloat16),
    "m33_k256_n128_fp32": dict(M=33, K=256, N=128, dtype=torch.float32),
}


def _nf4_inputs(dev, *, M, K, N, dtype, seed=0):
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(K, N, generator=g, device=dev) / K ** 0.5
    qt = quantize(w, QuantizationConfig(load_in_4bit=True, quant_type="nf4",
                                        compute_dtype=torch.float32))
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    return x, qt


@pytest.mark.parametrize("name", sorted(NF4_CASES))
def test_nf4_matmul_kernel_matches_plain(hopper, name):
    from accelerate_tpu_torch.ops import nf4_matmul as nm

    spec = NF4_CASES[name]
    x, qt = _nf4_inputs(hopper, **spec)
    assert nm.routes_to_kernel(qt)
    before = nm.nf4_matmul.launches
    out = nm.nf4_matmul(x, qt)
    torch.cuda.synchronize()
    assert nm.nf4_matmul.launches == before + 1
    ref = nm.nf4_matmul_reference(x, *nm.plane_pack(qt))
    assert out.dtype == x.dtype and out.shape == (spec["M"], spec["N"])
    atol, rtol = NF4_TOL[spec["dtype"]]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("M", [1, 16, 512])
def test_nf4_matmul_kernel_gives_equal_bits_twice_without_a_workspace(hopper, M):
    """A tile's K splits are summed in one cluster's shared memory in split
    order: two launches agree to the bit, and a call allocates its output
    and nothing else."""
    from accelerate_tpu_torch.ops import nf4_matmul as nm

    x, qt = _nf4_inputs(hopper, M=M, K=768, N=3072, dtype=torch.bfloat16)
    first = nm.nf4_matmul(x, qt)  # also packs and caches the planes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    second = nm.nf4_matmul(x, qt)
    torch.cuda.synchronize()
    # the caching allocator's block of the output: 512-byte steps below 1 MiB,
    # at most the next 2 MiB above
    block = 512 if second.nbytes < 1 << 20 else 2 << 20
    assert torch.cuda.max_memory_allocated() - base <= -(-second.nbytes // block) * block
    assert torch.equal(first, second)


def test_nf4_matmul_kernel_replays_from_a_cuda_graph(hopper):
    from accelerate_tpu_torch.ops import nf4_matmul as nm

    x, qt = _nf4_inputs(hopper, M=16, K=768, N=3072, dtype=torch.bfloat16)
    _graph_replays_like_eager(lambda: nm.nf4_matmul(x, qt),
                              lambda: x.copy_(torch.randn_like(x.float()).to(x.dtype)))


def test_nf4_matmul_leading_dims_and_plain_route_on_the_card(hopper):
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.utils.quantization import dequantize

    x, qt = _nf4_inputs(hopper, M=6, K=256, N=512, dtype=torch.bfloat16)
    got = nm.nf4_matmul(x.reshape(2, 3, 256), qt)
    assert got.shape == (2, 3, 512)
    torch.testing.assert_close(got.reshape(6, 512), nm.nf4_matmul(x, qt), atol=0, rtol=0)
    x, odd = _nf4_inputs(hopper, M=4, K=64, N=192, dtype=torch.float32)  # N % 128: plain route
    before = nm.nf4_matmul.launches
    out = nm.nf4_matmul(x, odd)
    assert nm.nf4_matmul.launches == before
    torch.testing.assert_close(out, x @ dequantize(odd, torch.float32))


@pytest.mark.parametrize("bad,exc", [("cpu_weight", ValueError), ("float64", TypeError)])
def test_nf4_matmul_kernel_rejects_what_it_does_not_take(hopper, bad, exc):
    from accelerate_tpu_torch.ops import nf4_matmul as nm

    x, qt = _nf4_inputs(hopper, M=4, K=256, N=256, dtype=torch.float32)
    if bad == "cpu_weight":
        packed, scales = nm.plane_pack(qt)
        qt._plane_pack = (packed.cpu(), scales.cpu())
    else:
        x = x.double()
    before = nm.nf4_matmul.launches
    with pytest.raises(exc):
        nm.nf4_matmul(x, qt)
    assert nm.nf4_matmul.launches == before


def test_int8_kv_engine_step_launches_the_paged_kernel_with_scale_pools(hopper):
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.serving import Request, SamplingParams, ServingEngine

    cfg = GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2, kv_cache_dtype=torch.int8)
    model = GPT2LMHead(cfg, device=hopper)
    streams = {}
    for attention in ("gather", "fused"):
        engine = ServingEngine(model, max_concurrency=2, prompt_buckets=(64,), paged_kv=True,
                               paged_attention=attention, weight_quant="nf4")
        paged = cfg.n_layer if attention == "fused" else 0
        assert engine.graph_launches == {"paged_decode_attention": paged,
                                         "nf4_matmul": 4 * cfg.n_layer}
        paged_decode_attention.launches = nm.nf4_matmul.launches = 0
        engine.submit(Request(prompt=list(range(3, 40)), params=SamplingParams(max_new_tokens=4)))
        engine.step()  # admission (eager) and the first decode step (one graph replay)
        assert engine.metrics.decode_dispatches.value == 1
        # the replay's launches were counted by the wrappers during the capture
        launches = tuple(fn.launches + engine.graph_launches[fn.__name__]
                         for fn in (paged_decode_attention, nm.nf4_matmul))
        assert launches == (paged, 2 * 4 * cfg.n_layer)
        while engine.has_work:
            for out in engine.step():
                streams[attention] = out.tokens
        assert engine.quant_stats()["kv_bits"] == 8
    assert streams["fused"] == streams["gather"]


# the paged engine with the decode kernel (the engine's default is the slot pool)
PAGED = dict(paged_kv=True, paged_attention="fused")


def _graph_engine_requests(sampled: bool):
    from accelerate_tpu_torch.serving import Request, SamplingParams

    g = torch.Generator().manual_seed(5)
    lens = torch.randint(3, 60, (6,), generator=g).tolist()
    prompts = [torch.randint(0, 256, (n,), generator=g).tolist() for n in lens]
    return [Request(prompt=p, params=SamplingParams(
                max_new_tokens=20, temperature=0.8 if sampled and i % 2 else 0.0,
                top_k=7 if sampled and i % 2 else None, seed=i))
            for i, p in enumerate(prompts)]


def test_graph_engine_streams_equal_generate(hopper):
    """The decode step as one CUDA graph replay, depth 2, four iterations a
    replay, six requests over four slots (backfill): fp32 greedy streams
    equal the eager, gather-path `generate` of each request alone, and so do
    the sampled ones, with the noise drawn from a generator seeded alike."""
    from accelerate_tpu_torch.models.generation import generate
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ServingEngine

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2), device=hopper)
    engine = ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64), pipeline_depth=2,
                           tokens_per_sync=4, **PAGED)
    assert engine.graph_launches["paged_decode_attention"] == 4 * model.config.n_layer
    requests = _graph_engine_requests(sampled=True)
    outs = engine.run(requests)
    for r, o in zip(requests, outs):
        sp = r.params
        gen = torch.Generator(device=hopper).manual_seed(sp.seed)
        assert o.tokens == generate(model, torch.tensor([r.prompt]), 20, temperature=sp.temperature,
                                    top_k=sp.top_k, generator=gen)[0].tolist()
    assert engine.metrics.decode_dispatches.value * 4 == engine.metrics.decode_steps.value


def test_graph_engine_runs_give_equal_bits(hopper):
    """Two bf16 engines serve the same greedy and sampled requests: equal
    token streams and equal KV pool bytes."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ServingEngine

    cfg = GPT2Config.tiny(dtype=torch.bfloat16, param_dtype=torch.bfloat16, n_embd=128, n_head=2)
    model = GPT2LMHead(cfg, device=hopper)
    runs = []
    for _ in range(2):
        engine = ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64),
                               tokens_per_sync=2, **PAGED)
        outs = [o.tokens for o in engine.run(_graph_engine_requests(sampled=True))]
        torch.cuda.synchronize()
        # the storages without the sink block, which takes dropped writes
        runs.append((outs, [t[:-1].clone() for layer in range(cfg.n_layer)
                            for t in engine._cache.storages(layer)]))
    (outs, pools), (outs2, pools2) = runs
    assert outs == outs2
    assert all(torch.equal(a, b) for a, b in zip(pools, pools2))


def test_graph_engine_capture_survives_another_threads_cuda_calls(hopper):
    """The decode step is captured while another thread of the process
    keeps querying an event and the free memory (as the profiler's CUPTI
    threads call into CUDA after a profiled window): every capture holds,
    and the engines serve equal streams."""
    import threading

    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ServingEngine

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2), device=hopper)
    stop, calls = threading.Event(), [0]

    def query():
        stream = torch.cuda.Stream(hopper)
        with torch.cuda.stream(stream):
            event = torch.cuda.Event()
            event.record()
            while not stop.is_set():
                event.query()
                torch.cuda.mem_get_info(hopper)
                calls[0] += 1

    thread = threading.Thread(target=query)
    thread.start()
    try:
        engines = [ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64), **PAGED)
                   for _ in range(4)]
    finally:
        stop.set()
        thread.join()
    assert calls[0] > 0
    streams = [[o.tokens for o in e.run(_graph_engine_requests(sampled=False))] for e in engines]
    assert all(s == streams[0] for s in streams)


def test_graph_engine_capture_runs_no_garbage_collection(hopper):
    """A collection inside the decode step's capture could destroy the graph
    of an engine dropped in a reference cycle, an unsafe call that
    invalidates the capture. With the collector set to run at almost every
    allocation, none runs while a graph is recorded, and engines dropped in
    a cycle do not break the next capture."""
    import gc

    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ServingEngine

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2), device=hopper)
    during = []

    def watch(phase, info):
        if phase == "start":
            during.append(torch.cuda.is_current_stream_capturing())

    threshold = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(1)
    try:
        for _ in range(3):
            old = ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64), **PAGED)
            old.cycle = old
            del old
            engine = ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64), **PAGED)
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*threshold)
    assert during and not any(during)
    outs = engine.run(_graph_engine_requests(sampled=False))
    assert all(len(o.tokens) == 20 for o in outs)


def test_slot_graph_engine_streams_equal_generate(hopper):
    """The slot-pool engine (the default) decodes as one CUDA graph replay
    too, and launches no kernel there (the slot step is plain PyTorch, as
    the reference's is XLA): at depth 2, four iterations a replay, its fp32
    greedy and sampled streams equal `generate`'s over the slot cache."""
    from accelerate_tpu_torch.models.generation import generate
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ServingEngine

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2), device=hopper)
    engine = ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64), pipeline_depth=2,
                           tokens_per_sync=4)
    assert engine._graph is not None and not engine.paged
    assert engine.graph_launches == {"paged_decode_attention": 0, "nf4_matmul": 0}
    requests = _graph_engine_requests(sampled=True)
    outs = engine.run(requests)
    for r, o in zip(requests, outs):
        sp = r.params
        gen = torch.Generator(device=hopper).manual_seed(sp.seed)
        assert o.tokens == generate(model, torch.tensor([r.prompt]), 20, temperature=sp.temperature,
                                    top_k=sp.top_k, generator=gen)[0].tolist()


def test_slot_graph_engine_runs_give_equal_bits(hopper):
    """Two bf16 slot engines serve the same requests: equal streams and
    equal slot-cache bytes, index included."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ServingEngine

    cfg = GPT2Config.tiny(dtype=torch.bfloat16, param_dtype=torch.bfloat16, n_embd=128, n_head=2)
    model = GPT2LMHead(cfg, device=hopper)
    runs = []
    for _ in range(2):
        engine = ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64),
                               tokens_per_sync=2)
        outs = [o.tokens for o in engine.run(_graph_engine_requests(sampled=True))]
        torch.cuda.synchronize()
        runs.append((outs, [t.clone() for t in engine._cache.k + engine._cache.v
                            + [engine._cache.index]]))
    (outs, cache), (outs2, cache2) = runs
    assert outs == outs2
    assert all(torch.equal(a, b) for a, b in zip(cache, cache2))


def test_llama_nf4_decode_runs_the_kernel(hopper):
    """An nf4 Llama (widths the kernel takes: N a multiple of 128) decodes
    through `generate` on the kernel, 7 projections a layer each forward:
    the eager prefill's launches counted by the wrapper, the decode steps'
    through the replays of the captured graph (what the wrapper counted
    while it was recorded, times the replays). Its greedy tokens equal the
    dense model's over the dequantized copy (fp32, TF32 off), which
    launches none, and the eager step's."""
    from accelerate_tpu_torch.models import generation
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.ops import nf4_matmul as nm
    from accelerate_tpu_torch.utils.quantization import (
        QuantizationConfig,
        dequantize_module,
        quantize_module,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.tiny(dtype=torch.float32, hidden_size=256, intermediate_size=512,
                           num_heads=4, num_kv_heads=2, sliding_window=24)
    model = quantize_module(LlamaForCausalLM(cfg, device=hopper),
                            QuantizationConfig(load_in_4bit=True, compute_dtype=torch.float32))
    dense = dequantize_module(model)
    ids = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(3))
    per_forward = 7 * cfg.num_layers
    got = generation.generate(model, ids, 12)  # captures the decode step
    held = generation._CAPTURED[model]
    assert held.launches == {"nf4_matmul": per_forward}
    graph, replays = held.graph, held.replays
    nm.nf4_matmul.launches = 0
    again = generation.generate(model, ids, 12)  # replays it from the first step
    assert held.graph is graph and held.replays - replays == 11
    assert nm.nf4_matmul.launches == per_forward  # the prefill
    assert nm.nf4_matmul.launches + per_forward * (held.replays - replays) == per_forward * 12
    assert torch.equal(again, got)
    nm.nf4_matmul.launches = 0
    assert torch.equal(got, generation.generate(dense, ids, 12))
    assert nm.nf4_matmul.launches == 0 and generation._CAPTURED[dense].launches == {"nf4_matmul": 0}
    assert torch.equal(got, generation._generate(model, ids, 12, 0.0, None, None, model.device,
                                                 capture=False))


@pytest.mark.parametrize("kind", ["gpt2", "llama_int8_kv"])
def test_captured_generate_equals_eager(hopper, kind):
    """`generate` replays its decode step as a captured CUDA graph; the
    eager step (`generation._generate` with ``capture=False``) gives the
    same tokens, greedy and sampled (the noise drawn from a generator seeded
    alike)."""
    from accelerate_tpu_torch.models.generation import _generate, generate
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    if kind == "gpt2":
        model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device=hopper)
    else:
        model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, sliding_window=5,
                                                  kv_cache_dtype=torch.int8), device=hopper)
    g = torch.Generator().manual_seed(4)
    for temperature, top_k in ((0.0, None), (0.9, 20)):
        # the second call of a batch size replays the first call's graph
        for prompt_len in (7, 12):
            ids = torch.randint(0, 256, (3, prompt_len), generator=g)
            replayed = generate(model, ids, 12, temperature=temperature, top_k=top_k,
                                generator=torch.Generator(device=hopper).manual_seed(9))
            eager = _generate(model, ids, 12, temperature, top_k,
                              torch.Generator(device=hopper).manual_seed(9), model.device,
                              capture=False)
            assert torch.equal(replayed, eager)


def test_generate_keeps_one_captured_step_a_model(hopper):
    """`generate` keeps one captured step a model: a call with another batch
    size or mode replaces it (nothing holds the old one), and
    `release_captured` frees its slot cache at once."""
    import gc
    import weakref

    from accelerate_tpu_torch.models import generation
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.models.kv_cache import tree_nbytes

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device=hopper)
    ids = torch.randint(0, 256, (4, 6), generator=torch.Generator().manual_seed(5))
    dropped = []
    for b, temperature in ((4, 0.0), (2, 0.0), (2, 0.8), (4, 0.0)):
        generation.generate(model, ids[:b], 8, temperature=temperature,
                            generator=torch.Generator(device=hopper).manual_seed(1))
        kept = generation._CAPTURED[model]
        assert (kept.batch, kept.sampled) == (b, temperature > 0)
        gc.collect()
        assert all(ref() is None for ref in dropped)
        dropped.append(weakref.ref(kept))
    torch.cuda.synchronize(hopper)
    nbytes = tree_nbytes(kept.cache)
    del kept
    before = torch.cuda.memory_allocated(hopper)
    generation.release_captured(model)
    gc.collect()
    assert model not in generation._CAPTURED and dropped[-1]() is None
    assert before - torch.cuda.memory_allocated(hopper) >= nbytes > 0


def test_captured_generate_recaptures_after_an_in_place_swap(hopper):
    """A model quantized in place (`quantize_model`) reads new tensors: the
    kept graph is captured anew, and its tokens are the eager ones."""
    from accelerate_tpu_torch.models import generation
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize_model

    cfg = LlamaConfig.tiny(dtype=torch.float32, hidden_size=256, intermediate_size=512)
    model = LlamaForCausalLM(cfg, device=hopper)
    ids = torch.randint(0, 256, (2, 5), generator=torch.Generator().manual_seed(2))
    generation.generate(model, ids, 8)
    first = generation._CAPTURED[model].graph
    quantize_model(model, QuantizationConfig(load_in_4bit=True, compute_dtype=torch.float32))
    got = generation.generate(model, ids, 8)
    assert generation._CAPTURED[model].graph is not first
    assert torch.equal(got, generation._generate(model, ids, 8, 0.0, None, None, model.device,
                                                 capture=False))


@pytest.mark.parametrize("mode", ["paged_fused", "slot"])
def test_health_flag_freezes_a_poisoned_row_inside_the_captured_graph(hopper, mode):
    """The health flag is part of the captured decode graph: a row the
    poison buffer marks gets NaN logits and a down health flag from the
    replay itself (no eager decode runs), freezes (position and token
    carried), and is quarantined; every other row advances. The quarantined
    request re-prefills, and every stream equals a clean engine's."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.reliability import FaultInjector, FaultSpec, inject
    from accelerate_tpu_torch.serving import ServingEngine

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2), device=hopper)
    kw = dict(max_concurrency=4, prompt_buckets=(16, 64), pipeline_depth=1,
              **(PAGED if mode == "paged_fused" else {}))
    requests = _graph_engine_requests(sampled=True)[:4]
    clean = [o.tokens for o in ServingEngine(model, **kw).run(requests)]
    engine = ServingEngine(model, **kw)
    assert engine._graph is not None
    eager = []
    body = engine._step_body
    engine._step_body = lambda: (eager.append(1), body())
    planes = []
    process = engine._process_step
    engine._process_step = lambda entry, fetched, now, fin: (planes.append(fetched.copy()),
                                                             process(entry, fetched, now, fin))
    for r in _graph_engine_requests(sampled=True)[:4]:
        engine.submit(r)
    engine.step()  # admission and the first replay
    pos = engine._d_pos.clone()
    with inject(FaultInjector(specs=[FaultSpec.poison(at_steps=(0,), slots=(2,))])):
        engine.step()
    torch.cuda.synchronize()
    health, finished = planes[-1][0, 2], planes[-1][0, 1]
    assert health.tolist() == [1, 1, 0, 1] and finished[2] == 1
    moved = (engine._d_pos - pos).tolist()
    assert moved[2] == 0 and all(moved[i] == 1 for i in (0, 1, 3))
    assert engine.metrics.steps_poisoned.value == 1 and engine.poison_uploads == 1
    assert not engine._d_poison.any()  # cleared on the stream after the replay
    outs = {}
    while engine.has_work:
        for o in engine.step():
            outs[o.request_id] = o.tokens
    assert [outs[i] for i in range(4)] == clean
    assert not eager and engine.metrics.decode_dispatches.value > 0


@pytest.mark.parametrize("sync", [1, 4])
def test_resumed_sampled_streams_equal_the_uninterrupted_ones_on_the_card(hopper, tmp_path, sync):
    """A run dropped mid-decode and resumed from its journal continues
    every sampled stream as the uninterrupted run does: the resumed
    request's CUDA generator is fast-forwarded past one [vocab] draw per
    emitted token, through the same call the admission and the decode
    draws take."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ServingEngine

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2), device=hopper)
    kw = dict(max_concurrency=4, prompt_buckets=(16, 64), pipeline_depth=2, tokens_per_sync=sync,
              **PAGED)
    want = {o.request_id: o.tokens for o in ServingEngine(model, **kw).run(
        _graph_engine_requests(sampled=True))}
    path = tmp_path / "requests.journal"
    engine = ServingEngine(model, journal=path, **kw)
    for r in _graph_engine_requests(sampled=True):
        engine.submit(r)
    for _ in range(4 if sync == 1 else 2):
        engine.step()
    del engine
    fresh = ServingEngine(model, journal=path, **kw)
    report = fresh.resume()
    assert report.resumed
    outs = {rid: o.tokens for rid, o in report.completed.items()}
    while fresh.has_work:
        for o in fresh.step():
            outs[o.request_id] = o.tokens
    assert outs == want
    assert any(r.params.temperature > 0 for r in _graph_engine_requests(sampled=True)
               if r.params.seed in report.resumed)


def test_supervised_fused_engine_restarts_on_the_card(hopper, tmp_path):
    """`EngineSupervisor` over the paged fused engine: an injected
    ``device_error`` and a ``step_hang`` past the stall timeout each rebuild
    the engine (its graph captured again) and resume the journal; the fp32
    streams equal an uninterrupted engine's, the first steps (kernel loads,
    graph captures) are never stalls, and the restarts leave the allocated
    device memory where one engine's is."""
    import gc

    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.reliability import FaultInjector, FaultSpec, inject
    from accelerate_tpu_torch.serving import (
        EngineSupervisor,
        ServingEngine,
        SupervisorConfig,
        Tracer,
    )

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2), device=hopper)

    def factory(**kw):
        return ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64), **PAGED, **kw)

    want = {o.request_id: o.tokens for o in factory().run(_graph_engine_requests(sampled=True))}
    gc.collect()
    torch.cuda.synchronize()
    tracer = Tracer()
    sup = EngineSupervisor(factory, tmp_path / "j.journal", tracer=tracer,
                           config=SupervisorConfig(stall_timeout_s=0.5, max_restarts=4))
    torch.cuda.synchronize()
    one_engine = torch.cuda.memory_allocated()
    inj = FaultInjector(seed=0, specs=[FaultSpec.device_error(at_calls=(9,)),
                                       FaultSpec.step_hang(at_calls=(20,), hang_s=1.0)])
    got = {}
    with inject(inj):
        for r in _graph_engine_requests(sampled=True):
            assert sup.submit(r).accepted
        while sup.has_work:
            for o in sup.step():
                got[o.request_id] = o.tokens
    assert [e.data["reason"] for e in tracer.events() if e.kind == "restart"] == [
        "device_error", "stall"]
    assert got == want
    assert sup.metrics.supervisor_stalls.value == 1  # the hang only
    assert sup.metrics.compile_count.value >= 3  # a capture per engine
    assert tracer.validate()["clean"]
    sup.close()
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= one_engine + (1 << 20)


def test_two_replica_cluster_streams_equal_a_lone_engine_on_the_card(hopper, tmp_path):
    """`ServingCluster` of two supervised paged fused engines over one
    model, under both placements: fp32 greedy and sampled streams equal a
    lone engine's token for token, and both replicas replay their decode
    graphs (kernel #1 in each)."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ClusterConfig, ServingCluster, ServingEngine

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2), device=hopper)

    def factory(**kw):
        return ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64), **PAGED, **kw)

    want = [o.tokens for o in factory().run(_graph_engine_requests(sampled=True))]
    for policy in ("prefix", "round_robin"):
        cluster = ServingCluster(factory, tmp_path / policy, replicas=2,
                                 config=ClusterConfig(policy=policy))
        rids = [cluster.submit(r).request_id for r in _graph_engine_requests(sampled=True)]
        outs = {}
        while cluster.has_work:
            for o in cluster.step():
                outs[o.request_id] = o.tokens
        assert [outs[rid] for rid in rids] == want
        for rep in cluster.replicas:
            assert rep.engine.graph_launches["paged_decode_attention"] == model.config.n_layer
            assert rep.metrics.decode_dispatches.value > 0
        cluster.close()


def test_spawn_and_retire_gives_the_memory_back_on_the_card(hopper, tmp_path):
    """A replica spawned while another has dispatches in flight captures its
    graph, serves, and retires: after three such cycles the allocated device
    memory is back within 1 MiB of where it was before the first spawn, and
    the spawned replicas' streams equal a lone engine's."""
    import gc

    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ServingCluster, ServingEngine

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2), device=hopper)

    def factory(**kw):
        return ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64), **PAGED, **kw)

    want = [o.tokens for o in factory().run(_graph_engine_requests(sampled=True))]
    cluster = ServingCluster(factory, tmp_path, replicas=1)
    for r in _graph_engine_requests(sampled=False):
        assert cluster.submit(r).accepted
    cluster.step()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    in_flight = []
    for _ in range(3):
        in_flight.append(len(cluster.replicas[0].engine._inflight))
        rep = cluster.add_replica()  # captures while replica 0 may have work in flight
        erids = [rep.supervisor.submit(r).request_id for r in _graph_engine_requests(sampled=True)]
        got = {}
        while cluster.has_work:
            for o in cluster.step():
                index, erid = cluster.placement(o.request_id)
                if index == rep.index:
                    got[erid] = o.tokens
        assert [got[e] for e in erids] == want
        cluster.retire_replica(rep.index)
        cluster.step()
        assert rep.retired and rep.engine._graph is None
    assert in_flight[0] >= 1
    gc.collect()
    torch.cuda.synchronize()
    assert abs(torch.cuda.memory_allocated() - before) <= 1 << 20
    cluster.close()


def test_annotated_dispatches_wrap_the_graph_replays(hopper):
    """``Tracer(annotate=True)``: in a profiler window each decode replay
    runs inside its ``record_function("step")`` range, and the window
    holds the paged-decode kernel launched by the replays."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ServingEngine, Tracer

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2), device=hopper)
    tracer = Tracer(annotate=True)
    engine = ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64), tracer=tracer,
                           **PAGED)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.run(_graph_engine_requests(sampled=False))
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()]
    replays = sum(1 for e in tracer.events() if e.kind == "dispatch" and e.data["what"] == "step")
    assert names.count("step") >= replays > 0
    assert any(n.startswith("admit[pb") for n in names)
    assert any("paged_decode" in n for n in names)
    assert tracer.validate()["clean"]


def _facade_gpt2(dev):
    """A narrow GPT-2 on flash attention (head_dim 64) with the fused-CE loss,
    prepared in bf16 with accumulation over 2 microbatches."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    cfg = GPT2Config.tiny(n_embd=128, n_head=2, n_positions=256, attention_impl="flash")
    module = GPT2LMHead(cfg, device=dev, seed=0)
    acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2, device=dev)
    opt = torch.optim.AdamW(module.parameters(), lr=1e-3, weight_decay=1e-4)
    return acc, module, *acc.prepare(module, opt)


def test_facade_explicit_loop_equals_make_train_step_on_the_card(hopper):
    """The imperative loop (``accumulate``, ``backward``, ``clip_grad_norm_``,
    ``step``, ``zero_grad``) and ``make_train_step`` over the same 4
    microbatches: equal losses and parameters, bit for bit, with the flash
    and fused-CE kernels launched by both."""
    from accelerate_tpu_torch.models.gpt2 import lm_loss_fn_pallas
    from accelerate_tpu_torch.ops import fused_ce

    g = torch.Generator(device=hopper).manual_seed(0)
    batches = [{"input_ids": torch.randint(0, 256, (2, 256), generator=g, device=hopper)}
               for _ in range(4)]
    runs = {}
    for form in ("explicit", "fused"):
        acc, module, model, opt = _facade_gpt2(hopper)
        before = (flash_attention_fwd.launches, fused_ce.fused_ce_dw.launches)
        if form == "explicit":
            losses = []
            for b in batches:
                with acc.accumulate(model):
                    losses.append(acc.backward(lm_loss_fn_pallas, b))
                    if acc.sync_gradients:
                        acc.clip_grad_norm_(max_norm=1.0)
                    opt.step()
                    opt.zero_grad()
        else:
            step = acc.make_train_step(lm_loss_fn_pallas, max_grad_norm=1.0)
            losses = [step(b) for b in batches]
        assert flash_attention_fwd.launches - before[0] == 4 * 2
        assert fused_ce.fused_ce_dw.launches - before[1] == 4
        runs[form] = ([x.item() for x in losses], {n: p.detach().clone()
                                                   for n, p in module.named_parameters()})
    assert runs["explicit"][0] == runs["fused"][0]
    for name, p in runs["explicit"][1].items():
        assert torch.equal(p, runs["fused"][1][name]), name


def test_fp16_bert_overflow_skips_the_update_and_the_scheduler_on_the_card(hopper):
    """BERT tiny in fp16 on the card: a step whose loss is made infinite
    leaves the parameters and the lr as they were and halves the scale; the
    next step applies."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
        classification_loss_fn,
    )
    from accelerate_tpu_torch.scheduler import schedule_lambda

    acc = Accelerator(mixed_precision="fp16", device=hopper)
    module = BertForSequenceClassification(BertConfig.tiny(), device=hopper, seed=0)
    opt = torch.optim.AdamW(module.parameters())
    model, opt, sched = acc.prepare(module, opt, schedule_lambda(opt, lambda n: 1e-3 * (n + 1)))
    g = torch.Generator(device=hopper).manual_seed(0)
    batch = {"input_ids": torch.randint(0, 1024, (4, 64), generator=g, device=hopper),
             "labels": torch.randint(0, 2, (4,), generator=g, device=hopper)}
    poison = {"on": False}

    def loss_fn(bound, b):
        loss = classification_loss_fn(bound, b)
        return loss * float("inf") if poison["on"] else loss

    def run():
        with acc.accumulate(model):
            acc.backward(loss_fn, batch)
            opt.step()
            sched.step()
            opt.zero_grad()

    run()
    scale, lr = opt.scaler_state.scale.item(), sched.get_last_lr()
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    poison["on"] = True
    run()
    assert opt.step_was_skipped and opt.skipped_updates == 1 and opt.num_updates == 1
    assert sched.get_last_lr() == lr and opt.scaler_state.scale.item() == scale / 2
    for name, p in module.named_parameters():
        assert torch.equal(p, before[name]), name
    poison["on"] = False
    run()
    assert not opt.step_was_skipped and opt.num_updates == 2


def _tier_buffers(engine) -> list[int]:
    """Addresses of every buffer the decode graph reads or writes that a
    tier wake restamps: rebinding one would leave the graph on stale
    memory."""
    bufs = [engine._d_tables, engine._d_tokens, engine._d_pos, engine._d_temps, engine._d_topks,
            engine._d_remaining, engine._d_finished, engine._cache.index]
    bufs += [t for layer in range(len(engine._cache.k)) for t in engine._cache.storages(layer)]
    return [t.data_ptr() for t in bufs]


@pytest.mark.parametrize("policy", ["upload", "prefill"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32_pool", "int8_pool"])
def test_tier_wake_between_depth2_replays_on_the_card(hopper, policy, quant):
    """A wake lands between two depth-2 replays of the captured decode
    graph: every active slot is hibernated while a replay is in flight and
    woken (an upload restamps the slot in place) before the next; fp32
    greedy and sampled streams equal the tier-off engine's, the graph's
    buffers keep their addresses, the uploads' host buffers are released
    once their copies ran, and the allocated memory after the drain is
    what it was after the build."""
    import gc

    import numpy as np

    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import KVTierConfig, ServingEngine

    cfg = GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2,
                          kv_cache_dtype=torch.int8 if quant else None)
    model = GPT2LMHead(cfg, device=hopper)
    kw = dict(max_concurrency=4, prompt_buckets=(16, 64), pipeline_depth=2, **PAGED)
    want = [o.tokens for o in ServingEngine(model, **kw).run(_graph_engine_requests(sampled=True))]
    gc.collect()
    torch.cuda.synchronize()
    engine = ServingEngine(model, kv_tier=KVTierConfig(wake_policy=policy), **kw)
    built, addresses = torch.cuda.memory_allocated(), _tier_buffers(engine)
    requests = _graph_engine_requests(sampled=True)
    for r in requests:
        assert engine.submit(r).accepted
    outs, forced = {}, 0
    while engine.has_work:
        for o in engine.step():
            outs[o.request_id] = o.tokens
        if forced < 3 and engine._inflight:
            ready = [int(s) for s in np.flatnonzero(engine._active)
                     if len(engine._slot_out[int(s)].tokens) >= 2]
            for s in ready:
                engine.kv_tier.hibernate_slot(s)
            forced += bool(ready)
    assert forced == 3
    assert [outs[r.request_id] for r in requests] == want
    assert _tier_buffers(engine) == addresses
    tier = engine.kv_tier
    tier.settle(block=True)
    assert tier.uploads_in_flight == 0 and tier.host_bytes == 0
    assert engine.metrics.host_wakeups.value >= 3
    assert (engine.metrics.host_page_ins.value > 0) == (policy == "upload")
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == built


def test_tier_spill_waits_for_inflight_writes_on_the_card(hopper):
    """A hibernation's gather is ordered behind the replays in flight: the
    host copy of a slot's blocks equals the pool's bytes read after a full
    synchronise, for every block the copy covers."""
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ServingEngine

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2), device=hopper)
    engine = ServingEngine(model, max_concurrency=4, prompt_buckets=(16, 64), pipeline_depth=2,
                           kv_tier=True, **PAGED)
    for r in _graph_engine_requests(sampled=False)[:4]:
        assert engine.submit(r).accepted
    while not any(o is not None and len(o.tokens) >= 3 for o in engine._slot_out):
        engine.step()
    assert engine._inflight
    slot = next(s for s, o in enumerate(engine._slot_out) if o is not None and len(o.tokens) >= 3)
    out = engine._slot_out[slot]
    n = -(-(out.prompt_len + len(out.tokens) - 1) // 16)
    ids = [int(x) for x in engine._slot_table_host[slot][:n]]
    hb, seconds = engine.kv_tier._gather(ids)
    torch.cuda.synchronize()
    for host, leaf in zip(hb.leaves(), engine.kv_tier.leaves()):
        assert torch.equal(host, leaf[ids].cpu())
    assert seconds > 0 and hb.buf.is_pinned() and hb.crcs == engine.kv_tier._crcs(hb)
    while engine.has_work:
        engine.step()


def _resnet_step_on(device, weights, batch, cfg):
    """One fp32 forward and backward of ResNet on ``device``: (loss, global
    gradient norm)."""
    from accelerate_tpu_torch.models.resnet import ResNet, image_classification_loss_fn

    model = ResNet(cfg, device=device)
    model.load_state_dict(weights)
    loss = image_classification_loss_fn(model, {k: v.to(device) for k, v in batch.items()})
    loss.backward()
    norm = torch.linalg.vector_norm(torch.stack([p.grad.double().norm() for p in model.parameters()]))
    return loss.item(), norm.item()


def test_resnet50_fp32_step_on_the_card_equals_the_cpu_step(hopper):
    """ResNet-50 (cuDNN convolutions, TF32 off) against the same step on the
    CPU from the same weights and batch: loss within 1e-4, the gradient's
    global norm within 1e-3 relative."""
    from accelerate_tpu_torch.models.resnet import ResNet, ResNetConfig

    cfg = ResNetConfig.resnet50(dtype=torch.float32)
    weights = ResNet(cfg, device="cpu", seed=0).state_dict()
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randn(4, 64, 64, 3, generator=g),
             "label": torch.randint(0, 1000, (4,), generator=g)}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = _resnet_step_on(hopper, weights, batch, cfg)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = _resnet_step_on("cpu", weights, batch, cfg)
    assert abs(card[0] - cpu[0]) < 1e-4
    assert abs(card[1] - cpu[1]) < 1e-3 * cpu[1]


def test_find_executable_batch_size_recovers_from_a_real_oom_on_the_card(hopper):
    """1 GiB a batch unit: 256 and 128 cannot fit in 80 GB, so the card's
    allocator raises ``torch.cuda.OutOfMemoryError`` and the search halves;
    after `release_memory` the allocated bytes are back within 1 MiB."""
    import gc

    from accelerate_tpu_torch.memory import find_executable_batch_size, release_memory

    gc.collect()  # earlier tests' garbage would be freed by release_memory below
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tried = []

    @find_executable_batch_size(starting_batch_size=256)
    def attempt(batch_size):
        tried.append(batch_size)
        x = torch.empty(batch_size, 2**28, device=hopper)  # fp32: 1 GiB a row
        x.fill_(1.0)
        return float(x[-1, -1])

    assert attempt() == 1.0
    assert tried[:2] == [256, 128] and attempt.batch_size == tried[-1] <= 64
    release_memory()
    assert abs(torch.cuda.memory_allocated() - before) <= 2**20
