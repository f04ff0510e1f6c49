"""The port's band flash attention against the reference's, on the CPU.

The reference's `flash_attention(..., causal=True, window=W,
triangle_block=32)` runs its band kernels in Pallas interpret mode (as its own
tests run them on the CPU) over sequences of at most 128, so the band has
several cells per row and edge cells that the window cuts. The port's
`flash_attention` on a CPU tensor runs the band kernels' plain versions
through `_FlashBand`. Inputs are made with numpy from a seed; outputs and the
gradients of ``sum(out * cotangent)`` are compared, and GQA K/V gradients come
back in kv-head shape.
"""

import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.ops.attention import attention as jax_attention  # noqa: E402
from accelerate_tpu.ops.flash_attention import _bwd_band as jax_bwd_band  # noqa: E402
from accelerate_tpu.ops.flash_attention import _fwd_band as jax_fwd_band  # noqa: E402
from accelerate_tpu.ops.flash_attention import band_block_default as jax_band_block_default  # noqa: E402
from accelerate_tpu.ops.flash_attention import flash_attention as jax_flash_attention  # noqa: E402
from accelerate_tpu_torch.ops import flash_attention as port  # noqa: E402
from accelerate_tpu_torch.ops.attention import attention  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

B, BLOCK = 2, 32
# the tolerances of tests/test_torch_flash_attention.py: fp32 is the same
# arithmetic in another summation order (the reference's online softmax over
# 32-wide band cells, the plain version's one global max); bf16 rounds p and dS
# relative to a running max on one side and the global max on the other, and
# each output once more; |err| <= atol + rtol * |ref|
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}

CASES = {
    "w32_gqa_4q_2kv_fp32": dict(window=32, s=128, d=64, hq=4, hk=2, dtype="float32"),
    "w48_mha_fp32": dict(window=48, s=128, d=64, hq=2, hk=2, dtype="float32"),
    "w100_gqa_4q_1kv_fp32": dict(window=100, s=128, d=64, hq=4, hk=1, dtype="float32"),
    "triangle_gqa_4q_2kv_fp32": dict(window=None, s=128, d=64, hq=4, hk=2, dtype="float32"),
    "w48_d40_padded_fp32": dict(window=48, s=96, d=40, hq=2, hk=2, dtype="float32"),
    "w48_gqa_4q_1kv_bf16": dict(window=48, s=128, d=64, hq=4, hk=1, dtype="bfloat16"),
    "triangle_bf16": dict(window=None, s=96, d=64, hq=2, hk=2, dtype="bfloat16"),
    "w100_d40_padded_gqa_bf16": dict(window=100, s=128, d=40, hq=4, hk=2, dtype="bfloat16"),
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


def _exact_band_attention(q, k, v, window):
    """float64 softmax attention over BSHD numpy inputs, GQA heads repeated,
    query i over keys in (i - window, i] (keys <= i when window is None)."""
    rep = q.shape[2] // k.shape[2]
    q, k, v = (x.astype(np.float64) for x in (q, np.repeat(k, rep, 2), np.repeat(v, rep, 2)))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    i, j = np.arange(s.shape[-2])[:, None], np.arange(s.shape[-1])[None, :]
    keep = (j <= i) & ((j > i - window) if window is not None else True)
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("name", sorted(CASES))
def test_band_forward_and_grads_match_reference(name):
    spec = CASES[name]
    window, dtype = spec["window"], spec["dtype"]
    q, k, v, ct = _inputs(sorted(CASES).index(name), spec["s"], spec["d"], spec["hq"], spec["hk"])

    jq, jk, jv, jct = (jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in (q, k, v, ct))
    band = jax.jit(lambda a, b, c: jax_flash_attention(a, b, c, causal=True, window=window,
                                                       triangle_block=BLOCK))
    out, vjp = jax.vjp(band, jq, jk, jv)
    want = [np.asarray(x, dtype=np.float32) for x in (out, *vjp(jct))]

    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_() for x in (q, k, v))
    before = (port.flash_band_fwd.launches, port.flash_band_dq.launches, port.flash_band_dkv.launches)
    got_out = port.flash_attention(tq, tk, tv, causal=True, window=window, triangle_block=BLOCK)
    grads = torch.autograd.grad(got_out, (tq, tk, tv),
                                grad_outputs=torch.from_numpy(ct).to(getattr(torch, dtype)))
    after = (port.flash_band_fwd.launches, port.flash_band_dq.launches, port.flash_band_dkv.launches)
    assert after == before  # a CPU tensor takes the plain versions

    atol, rtol = TOL[dtype]
    if dtype == "float32":  # each side against exact attention first, so a drift names its side
        exact = _exact_band_attention(q, k, v, window)
        np.testing.assert_allclose(_np(got_out), exact, atol=atol, rtol=rtol, err_msg="port vs float64")
        np.testing.assert_allclose(want[0], exact, atol=atol, rtol=rtol, err_msg="reference vs float64")
    for label, g, w, src in zip(("out", "dq", "dk", "dv"), (got_out, *grads), want, (tq, tq, tk, tv)):
        # dk and dv in kv-head shape, in the input dtype
        assert g.dtype == src.dtype and tuple(g.shape) == w.shape == tuple(src.shape), label
        np.testing.assert_allclose(_np(g), w, atol=atol, rtol=rtol, err_msg=label)


@pytest.mark.parametrize("window,hq,hk", [(48, 4, 2), (None, 4, 1)])
def test_lse_and_plain_backward_match_reference_band_kernels(window, hq, hk):
    """The saved residual and the plain backward over ``[b, h, s, d]``: the
    plain band forward's fp32 logsumexp against `_fwd_band`'s (its 8-lane
    storage, first lane), and the plain dQ and dK/dV against `_bwd_band` on
    the same residuals, dK/dV summed over each kv head's group."""
    q, k, v, ct = _inputs(7, 128, 64, hq, hk)
    qt, kt, vt, dot = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q / 8.0, k, v, ct))
    jq, jk, jv = jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt)
    out, lse = jax.jit(lambda a, b, c: jax_fwd_band(a, b, c, BLOCK, window, True))(jq, jk, jv)
    want_grads = jax.jit(lambda r, g: jax_bwd_band(BLOCK, window, True, r, g))(
        (jq, jk, jv, out, lse), jnp.asarray(dot))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (qt, kt, vt, dot))
    got_out, got_lse = port.flash_band_forward_reference(tq, tk, tv, window)
    assert got_lse.dtype == torch.float32 and tuple(got_lse.shape) == (B, hq, 128)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), atol=1e-5, rtol=0)
    delta = (tdo * got_out).sum(-1)
    got_grads = (port.flash_band_dq_reference(tq, tk, tv, tdo, got_lse, delta, window),
                 *port.flash_band_dkv_reference(tq, tk, tv, tdo, got_lse, delta, window))
    for label, g, w in zip(("dq", "dk", "dv"), got_grads, want_grads):
        assert tuple(g.shape) == w.shape, label
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=label)


REFUSALS = {
    "window_not_causal": (dict(causal=False, window=16), 64, 64, "causal self-attention"),
    "window_cross": (dict(causal=True, window=16), 64, 32, "causal self-attention"),
    "window_below_1": (dict(causal=True, window=0), 64, 64, "window must be >= 1"),
    "window_untileable_seq": (dict(causal=True, window=16), 1031, 1031, "block divisor"),
    "triangle_not_causal": (dict(causal=False, triangle_block=32), 64, 64, "causal self-attention"),
    "triangle_with_block_q": (dict(causal=True, triangle_block=32, block_q=32), 64, 64,
                              "mutually exclusive"),
    "triangle_not_dividing": (dict(causal=True, triangle_block=48), 64, 64, "must divide seq 64"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_reference_value_errors_are_kept(name):
    """Each of the reference's argument rules raises ValueError on both
    sides, with the same message."""
    kwargs, sq, skv, match = REFUSALS[name]
    q = np.zeros((1, sq, 2, 32), np.float32)
    kv = np.zeros((1, skv, 2, 32), np.float32)
    with pytest.raises(ValueError, match=re.escape(match)) as want:
        jax_flash_attention(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), **kwargs)
    with pytest.raises(ValueError, match=re.escape(match)) as got:
        port.flash_attention(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv), **kwargs)
    if name != "window_untileable_seq":  # the port does not offer the env knob the hint names
        assert str(got.value) == str(want.value)


def test_band_block_default_matches_reference():
    for sq in (1, 7, 8, 64, 96, 100, 127, 128, 1000, 1031, 2048, 4099, 8192):
        assert port.band_block_default(sq) == jax_band_block_default(sq), sq


@pytest.mark.parametrize("implementation", ["xla", "flash", "auto"])
def test_attention_window_dispatch_matches_reference(implementation):
    """`attention(window=)` against the reference's dispatcher, GQA 4q/2kv
    passed unrepeated, with gradients on the port's side against the plain
    route; ``"auto"`` on the CPU takes the plain path and launches nothing."""
    q, k, v, ct = _inputs(11, 64, 32, 4, 2)
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                    window=24, implementation=implementation))
    counts = (port.flash_band_fwd, port.flash_band_dq, port.flash_band_dkv,
              port.flash_attention_fwd, port.flash_attention_dq, port.flash_attention_dkv)
    before = [fn.launches for fn in counts]
    outs, grads = [], []
    for impl in (implementation, "xla"):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = attention(tq, tk, tv, causal=True, window=24, implementation=impl)
        outs.append(out)
        grads.append(torch.autograd.grad(out, (tq, tk, tv), grad_outputs=torch.from_numpy(ct)))
    assert [fn.launches for fn in counts] == before
    np.testing.assert_allclose(_np(outs[0]), want, atol=1e-5, rtol=1e-5)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
