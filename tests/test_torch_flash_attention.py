"""The port's flash attention against the reference's, on the CPU.

The reference's `flash_attention` runs its Pallas kernels in interpret mode
(as its own tests run it on the CPU) with ``block_q = block_kv = 32`` on
sequences of 128, so several tiles and the causal tile skip are exercised.
The port's `flash_attention` on a CPU tensor runs the kernels' plain versions
through its `torch.autograd.Function`. Inputs are made with numpy from a seed;
outputs and the gradients of ``sum(out * cotangent)`` are compared.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.ops.flash_attention import _bwd as jax_bwd  # noqa: E402
from accelerate_tpu.ops.flash_attention import _fwd as jax_fwd  # noqa: E402
from accelerate_tpu.ops.flash_attention import flash_attention as jax_flash_attention  # noqa: E402
from accelerate_tpu_torch.ops import flash_attention as port  # noqa: E402
from accelerate_tpu_torch.ops.attention import attention  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

B, S, BLOCK = 2, 128, 32
# fp32: the same arithmetic in another summation order (the reference's
# online softmax over 32-wide tiles, the plain version's one global max).
# bf16: p and dS are rounded to bf16 relative to a running max on one side and
# the global max on the other, and outputs are rounded once more; the bar is
# relative, |err| <= atol + rtol * |ref|
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}

CASES = {
    "causal_d64_fp32": dict(causal=True, d=64, hq=2, hk=2, dtype="float32"),
    "full_d64_fp32": dict(causal=False, d=64, hq=2, hk=2, dtype="float32"),
    "causal_d40_padded_fp32": dict(causal=True, d=40, hq=2, hk=2, dtype="float32"),
    "causal_gqa_4q_2kv_fp32": dict(causal=True, d=64, hq=4, hk=2, dtype="float32"),
    "causal_d64_bf16": dict(causal=True, d=64, hq=2, hk=2, dtype="bfloat16"),
    "full_d40_padded_bf16": dict(causal=False, d=40, hq=2, hk=2, dtype="bfloat16"),
}


def _inputs(seed, d, hq, hk):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, S, hq, d)).astype(np.float32)
    k = r.standard_normal((B, S, hk, d)).astype(np.float32)
    v = r.standard_normal((B, S, hk, d)).astype(np.float32)
    ct = r.standard_normal((B, S, hq, d)).astype(np.float32)
    return q, k, v, ct


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t):
    return t.detach().float().numpy()


def _exact_attention(q, k, v, causal):
    """float64 softmax attention over BSHD numpy inputs, GQA heads repeated."""
    rep = q.shape[2] // k.shape[2]
    q, k, v = (x.astype(np.float64) for x in (q, np.repeat(k, rep, 2), np.repeat(v, rep, 2)))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_grads_match_reference(name):
    spec = CASES[name]
    causal, dtype = spec["causal"], spec["dtype"]
    q, k, v, ct = _inputs(sorted(CASES).index(name), spec["d"], spec["hq"], spec["hk"])

    jq, jk, jv, jct = (jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in (q, k, v, ct))
    out, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, causal=causal, block_q=BLOCK, block_kv=BLOCK),
        jq, jk, jv)
    want = [np.asarray(x, dtype=np.float32) for x in (out, *vjp(jct))]

    tq, tk, tv = (_to_torch(x, dtype).requires_grad_() for x in (q, k, v))
    got_out = port.flash_attention(tq, tk, tv, causal=causal, block_q=BLOCK, block_kv=BLOCK)
    grads = torch.autograd.grad(got_out, (tq, tk, tv), grad_outputs=_to_torch(ct, dtype))
    got = [got_out, *grads]

    atol, rtol = TOL[dtype]
    if dtype == "float32":  # each side against exact attention first, so a drift names its side
        exact = _exact_attention(q, k, v, causal)
        np.testing.assert_allclose(_np(got_out), exact, atol=atol, rtol=rtol, err_msg="port vs float64")
        np.testing.assert_allclose(want[0], exact, atol=atol, rtol=rtol, err_msg="reference vs float64")
    for label, g, w, src in zip(("out", "dq", "dk", "dv"), got, want, (tq, tq, tk, tv)):
        assert g.dtype == src.dtype and tuple(g.shape) == w.shape, label
        np.testing.assert_allclose(_np(g), w, atol=atol, rtol=rtol, err_msg=label)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_and_plain_backward_match_reference_kernels(causal):
    """The saved residual and the plain backward over ``[b, h, s, d]``: the
    plain forward's fp32 logsumexp against the reference kernel's (its 8-lane
    storage, first lane), and `flash_attention_backward_reference` against
    the reference's dQ and dK/dV kernels on the same residuals."""
    q, k, v, ct = _inputs(7, 64, 2, 2)
    qt, kt, vt, dot = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q / 8.0, k, v, ct))
    jq, jk, jv = jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt)
    out, lse = jax_fwd(jq, jk, jv, causal, BLOCK, BLOCK, True)
    want_grads = jax_bwd(causal, BLOCK, BLOCK, True, (jq, jk, jv, out, lse), jnp.asarray(dot))
    tq, tk, tv = (torch.from_numpy(x) for x in (qt, kt, vt))
    got_out, got_lse = port.flash_attention_forward_reference(tq, tk, tv, causal)
    assert got_lse.dtype == torch.float32 and tuple(got_lse.shape) == (B, 2, S)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), atol=1e-5, rtol=0)
    got_grads = port.flash_attention_backward_reference(tq, tk, tv, got_out, got_lse,
                                                        torch.from_numpy(dot), causal)
    for label, g, w in zip(("dq", "dk", "dv"), got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=label)


def test_cpu_runs_the_plain_versions_and_launches_nothing():
    q, k, v, ct = _inputs(3, 64, 2, 2)
    before = (port.flash_attention_fwd.launches, port.flash_attention_dq.launches,
              port.flash_attention_dkv.launches)
    tq = torch.from_numpy(q).requires_grad_()
    out = port.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v), causal=True)
    out.backward(torch.from_numpy(ct))
    after = (port.flash_attention_fwd.launches, port.flash_attention_dq.launches,
             port.flash_attention_dkv.launches)
    assert after == before


def test_reference_refusals_are_kept():
    x = torch.zeros(1, 100, 2, 64)
    with pytest.raises(ValueError, match="must divide block sizes"):
        port.flash_attention(x, x, x, causal=True, block_q=32)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port.flash_attention(torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 2, 64),
                             torch.zeros(1, 8, 2, 64))


def test_flash_route_equals_plain_route():
    """`attention(implementation="flash")` on the CPU (the kernels' plain
    versions) against the plain attention path, with gradients."""
    q, k, v, ct = _inputs(11, 64, 4, 2)
    outs, grads = [], []
    for impl in ("flash", "xla"):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = attention(tq, tk, tv, causal=True, implementation=impl)
        outs.append(out)
        grads.append(torch.autograd.grad(out, (tq, tk, tv), grad_outputs=torch.from_numpy(ct)))
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
