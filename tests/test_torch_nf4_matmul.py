"""The port's `ops.nf4_matmul` against the reference's.

`plane_pack` must give the reference's bytes and scales; `nf4_matmul` on the
CPU (the kernel's plain version) must match the reference's Pallas kernel in
interpret mode, at the reference test's shapes and tolerances (fp32 rtol 1e-4,
atol 1e-3: both accumulate the same fp32 products in another order; bf16
0.05: the output is rounded to bf16, and the reference's fallback check uses
the same bar); and the port must route to the kernel exactly the tensors the
reference routes to its kernel.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.ops import nf4_matmul as jops  # noqa: E402
from accelerate_tpu.utils import quantization as jq  # noqa: E402
from accelerate_tpu_torch.ops import nf4_matmul as tops  # noqa: E402
from accelerate_tpu_torch.utils import quantization as tq  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _pair(K, N, seed=0, **cfg):
    """The same weight quantized by both packages (reference bytes carried
    across)."""
    w = np.random.default_rng(seed).normal(size=(K, N)).astype(np.float32)
    cfg = cfg or dict(load_in_4bit=True, quant_type="nf4")
    ref = jq.quantize(w, jq.QuantizationConfig(**cfg))
    qt = tq.from_numpy(np.asarray(ref.data), np.asarray(ref.scales), ref.shape, ref.bits,
                       ref.quant_type)
    return ref, qt


def test_plane_pack_equals_reference_and_is_cached():
    ref, qt = _pair(128, 512)
    want_p, want_s = (np.asarray(a) for a in jops.plane_pack(ref))
    packed, scales2 = tops.plane_pack(qt)
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (128, 256)
    assert tuple(scales2.shape) == (2, 128, 4)
    np.testing.assert_array_equal(packed.numpy(), want_p)
    np.testing.assert_array_equal(scales2.numpy(), want_s)
    assert tops.plane_pack(qt)[0] is packed


@pytest.mark.parametrize("K,N,M", [(256, 256, 8), (128, 512, 1), (192, 384, 4)])
def test_matches_reference_kernel_fp32(K, N, M):
    ref, qt = _pair(K, N)
    x = np.random.default_rng(1).normal(size=(M, K)).astype(np.float32)
    want = np.asarray(jops.nf4_matmul(jnp.asarray(x), ref, interpret=True))
    before = tops.nf4_matmul.launches
    got = tops.nf4_matmul(torch.from_numpy(x), qt)
    assert tops.nf4_matmul.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_leading_dims_and_bf16_match_reference():
    ref, qt = _pair(128, 256)
    x = np.random.default_rng(2).normal(size=(2, 3, 128)).astype(np.float32)
    want = np.asarray(jops.nf4_matmul(jnp.asarray(x, jnp.bfloat16), ref, interpret=True),
                      np.float32)
    got = tops.nf4_matmul(torch.from_numpy(x).to(torch.bfloat16), qt)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 256)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("K,N,cfg", [
    (128, 256, dict(load_in_4bit=True, quant_type="nf4")),
    (100, 256, dict(load_in_4bit=True, quant_type="nf4")),  # K tile 100: kernel
    (300, 256, dict(load_in_4bit=True, quant_type="nf4")),  # K tile 4 < 8: plain
    (64, 192, dict(load_in_4bit=True, quant_type="nf4")),  # N % 128: plain
    (64, 64, dict(load_in_4bit=True, quant_type="nf4")),
    (128, 256, dict(load_in_4bit=True, quant_type="fp4")),
    (128, 256, dict(load_in_8bit=True)),
    (128, 256, dict(load_in_4bit=True, quant_type="nf4", block_size=128)),
    (768, 2304, dict(load_in_4bit=True, quant_type="nf4")),
    (3072, 768, dict(load_in_4bit=True, quant_type="nf4")),
])
def test_routing_matches_reference(K, N, cfg):
    ref, qt = _pair(K, N, **cfg)
    bk = min(256, K)
    while K % bk:
        bk //= 2
    P = N // 2
    top = min(128, P)
    bn = next((c for c in range(top - top % 64, 63, -64) if P % c == 0), 0)
    want = jops.kernel_supported(ref) and bk >= 8 and bn >= 64
    assert tops.kernel_supported(qt) == jops.kernel_supported(ref)
    assert tops.routes_to_kernel(qt) == want
    # every route computes x @ dequantize(W)
    x = np.random.default_rng(3).normal(size=(4, K)).astype(np.float32)
    dense = np.asarray(jq.dequantize(ref, jnp.float32))
    np.testing.assert_allclose(tops.nf4_matmul(torch.from_numpy(x), qt).numpy(), x @ dense,
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("cfg,shape,match", [
    (dict(load_in_8bit=True), (128, 256), "nf4"),
    (dict(load_in_4bit=True, quant_type="fp4"), (128, 256), "nf4"),
    (dict(load_in_4bit=True, quant_type="nf4"), (64, 192), "multiple of 128"),
    (dict(load_in_4bit=True, quant_type="nf4", block_size=128), (128, 256), "64-element"),
])
def test_plane_pack_errors_match_reference(cfg, shape, match):
    ref, qt = _pair(*shape, **cfg)
    with pytest.raises(ValueError, match=match) as want:
        jops.plane_pack(ref)
    with pytest.raises(ValueError, match=match) as got:
        tops.plane_pack(qt)
    assert str(got.value) == str(want.value)


def test_plane_pack_refuses_3d():
    w = np.random.default_rng(4).normal(size=(2, 64, 128)).astype(np.float32)
    qt = tq.quantize(torch.from_numpy(w), tq.QuantizationConfig(load_in_4bit=True))
    with pytest.raises(ValueError, match="2D"):
        tops.plane_pack(qt)


def test_split_k_covers_k_and_fills_the_card():
    for M, K, N in [(1, 4096, 4096), (1, 11008, 4096), (16, 768, 2304), (16, 3072, 768),
                    (512, 768, 2304), (3, 100, 256)]:
        splits, rows = tops.split_k(M, K, N)
        assert splits * rows >= K > (splits - 1) * rows
        if M <= 16 and K >= 64 * 16:
            assert splits > 1


# the shapes of chip_smoke.py's nf4 phase: the Llama-7B decode shapes at M 1
# and 16, GPT-2 small's projections at M 16 and 512, GPT-2's qkv in fp32
PHASE15_SHAPES = ([(M, K, N) for K, N in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
                   for M in (1, 16)]
                  + [(M, K, N) for K, N in ((768, 2304), (768, 768), (768, 3072), (3072, 768))
                     for M in (16, 512)])


@pytest.mark.parametrize("M,K,N", PHASE15_SHAPES)
def test_split_k_plan_is_one_cluster_of_whole_pieces(M, K, N):
    """The K splits of an output tile are the CTAs of one cluster (they sum
    their partials in its shared memory, so there is no workspace), each run
    is a multiple of 8 rows (x's 16-byte pieces), every split has rows, and
    the grid reaches every one of the card's 132 SMs where the shape has the
    work for it, with no split once the tiles alone give four CTAs a SM."""
    splits, rows = tops.split_k(M, K, N)
    assert 1 <= splits <= tops.MAX_SPLITS
    assert splits * rows >= K > (splits - 1) * rows
    assert splits == 1 or rows % 8 == 0
    tiles = -(-(N // 2) // 128) * -(-M // min(16, 1 << max(0, M - 1).bit_length()))
    assert tiles * splits >= min(132, tiles * tops.MAX_SPLITS)
    if tiles >= 4 * 132:
        assert splits == 1
