"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA Hopper GPU and nvcc, and skips elsewhere. The
file imports nothing of JAX, so it runs on a machine without it (the repo's
conftest imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from accelerate_tpu_torch.ops.flash_attention import (
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
    (dict(d=32), ValueError),  # head_dim the kernel is not built for
    (dict(hq=6, kvh=2), ValueError),  # GQA groups of 3
    (dict(dtype=torch.float64), TypeError),
])
def test_paged_decode_kernel_rejects_what_it_does_not_take(hopper, change, exc):
    spec = {**CASES["bf16_parked"], **change}
    args, _ = _inputs(hopper, **spec)
    with pytest.raises(exc):
        paged_decode_attention(*args)


def test_paged_decode_kernel_rejects_a_strided_pool(hopper):
    (q, k, v, tables, lens), _ = _inputs(hopper, **CASES["bf16_parked"])
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(q, k[::2], v[::2], tables // 2, lens)
