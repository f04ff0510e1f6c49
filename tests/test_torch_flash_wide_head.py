"""Flash attention at head_dim 192 and 256 (and 136, padded to 256): the
port against the reference, on the CPU.

The reference pads a head_dim that is not a multiple of 64 to a multiple of
128 and runs its Pallas kernels, rectangular and band, at any of them; here
they run in interpret mode (as its own tests run them on the CPU) with
32-wide tiles over sequences of 96 and 128. The port's `flash_attention` on a
CPU tensor runs the kernels' plain versions through its autograd functions.
Outputs and the gradients of ``sum(out * cotangent)`` are compared at the
tolerances of tests/test_torch_flash_attention.py. Then the kernels' head
dims: every padded head_dim the reference produces up to 256 is one the CUDA
kernels are built for, every multiple of 64 above runs their run-time
head_dim body, and d 320 and d 300 (padded to 384) are held to the reference
too.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.ops.flash_attention import flash_attention as jax_flash_attention  # noqa: E402
from accelerate_tpu_torch.ops import flash_attention as port  # noqa: E402

B, BLOCK = 1, 32
# fp32: the same arithmetic in another summation order; bf16: p and dS are
# rounded to bf16 relative to a running max on one side and the global max on
# the other, and outputs once more; |err| <= atol + rtol * |ref|
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}

CASES = {
    "rect_causal_d192_fp32": dict(window=None, band=False, causal=True, s=128, d=192, hq=2, hk=2,
                                  dtype="float32"),
    "rect_full_d256_gqa_fp32": dict(window=None, band=False, causal=False, s=96, d=256, hq=2, hk=1,
                                    dtype="float32"),
    "rect_causal_d136_padded_fp32": dict(window=None, band=False, causal=True, s=96, d=136, hq=2,
                                         hk=2, dtype="float32"),
    "rect_causal_d256_bf16": dict(window=None, band=False, causal=True, s=96, d=256, hq=2, hk=2,
                                  dtype="bfloat16"),
    "band_w48_d192_gqa_fp32": dict(window=48, band=True, causal=True, s=128, d=192, hq=4, hk=2,
                                   dtype="float32"),
    "band_triangle_d256_fp32": dict(window=None, band=True, causal=True, s=96, d=256, hq=2, hk=2,
                                    dtype="float32"),
    "band_w40_d136_padded_bf16": dict(window=40, band=True, causal=True, s=96, d=136, hq=2, hk=1,
                                      dtype="bfloat16"),
    # above 256 (named to sort after the cases above, whose seeds are
    # their sorted positions)
    "wide_rect_causal_d320_fp32": dict(window=None, band=False, causal=True, s=64, d=320, hq=2,
                                       hk=2, dtype="float32"),
    "wide_band_w40_d300_padded_gqa_fp32": dict(window=40, band=True, causal=True, s=64, d=300,
                                               hq=2, hk=1, dtype="float32"),
}


def _inputs(seed, s, d, hq, hk):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, s, hq, d)).astype(np.float32)
    k = r.standard_normal((B, s, hk, d)).astype(np.float32)
    v = r.standard_normal((B, s, hk, d)).astype(np.float32)
    ct = r.standard_normal((B, s, hq, d)).astype(np.float32)
    return q, k, v, ct


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_grads_match_reference(name):
    spec = CASES[name]
    dtype, window, causal = spec["dtype"], spec["window"], spec["causal"]
    q, k, v, ct = _inputs(sorted(CASES).index(name), spec["s"], spec["d"], spec["hq"], spec["hk"])
    kw = (dict(causal=True, window=window, triangle_block=BLOCK) if spec["band"]
          else dict(causal=causal, block_q=BLOCK, block_kv=BLOCK))

    jq, jk, jv, jct = (jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in (q, k, v, ct))
    out, vjp = jax.vjp(jax.jit(lambda a, b, c: jax_flash_attention(a, b, c, **kw)), jq, jk, jv)
    want = [np.asarray(x, dtype=np.float32) for x in (out, *vjp(jct))]

    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_() for x in (q, k, v))
    got_out = port.flash_attention(tq, tk, tv, **kw)
    grads = torch.autograd.grad(got_out, (tq, tk, tv),
                                grad_outputs=torch.from_numpy(ct).to(getattr(torch, dtype)))
    atol, rtol = TOL[dtype]
    for label, g, w, src in zip(("out", "dq", "dk", "dv"), (got_out, *grads), want, (tq, tq, tk, tv)):
        assert g.dtype == src.dtype and tuple(g.shape) == w.shape == tuple(src.shape), label
        np.testing.assert_allclose(_np(g), w, atol=atol, rtol=rtol, err_msg=label)


def _reference_padded(d: int) -> int:
    """The head_dim the reference's `flash_attention` runs its kernels at:
    a multiple of 64 stays, any other is zero-padded to a multiple of 128."""
    return d if d % 64 == 0 else d + (128 - d % 128) % 128


def test_every_padded_head_dim_up_to_256_has_a_kernel():
    padded = {_reference_padded(d) for d in range(1, 257)}
    assert padded == set(port.FLASH_KERNEL_HEAD_DIMS) == {64, 128, 192, 256}
    assert _reference_padded(136) == _reference_padded(200) == 256


def test_the_wrapper_pads_as_the_reference_does():
    """d 136 reaches the plain versions padded to 256, as the reference's
    kernels see it, and comes back cut to 136."""
    seen = []
    real = port.flash_attention_fwd

    def spy(q, k, v, causal):
        seen.append(q.shape[-1])
        return real(q, k, v, causal)

    port.flash_attention_fwd = spy
    try:
        out = port.flash_attention(*(torch.zeros(1, 8, 2, 136) for _ in range(3)), causal=True)
    finally:
        port.flash_attention_fwd = real
    assert seen == [256] and out.shape == (1, 8, 2, 136)


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_kernel_operands_take_every_built_head_dim(d):
    q = torch.zeros(1, 2, 8, d)
    assert len(port._kernel_operands("flash_attention_fwd", q, q, q)) == 3


@pytest.mark.parametrize("d", [320, 384, 96])
def test_kernel_operands_refuse_other_head_dims_naming_the_limit(d):
    """No upper limit is left: every multiple of 64 above 256 (what the
    padding gives there) runs the run-time head_dim body. A head_dim the
    padding never gives (96) is still refused, naming the rule."""
    q = torch.zeros(1, 2, 8, d)
    if d % 64:
        with pytest.raises(ValueError, match="multiple of 64 above 256"):
            port._kernel_operands("flash_attention_fwd", q, q, q)
    else:
        assert len(port._kernel_operands("flash_attention_fwd", q, q, q)) == 3
