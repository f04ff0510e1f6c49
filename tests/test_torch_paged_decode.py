"""The port's `paged_decode_attention` against the reference's.

The same inputs, made with numpy from a seed, go through the JAX package's
`paged_decode_attention` (its Pallas kernel under the interpreter, as the
reference's own CPU tests run it) and through the port's on CPU tensors, which
takes the port's plain PyTorch version. The CUDA kernel itself is held to that
plain version on the card by ``tests/test_torch_cuda_kernels.py`` and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from accelerate_tpu.models.kv_cache import _dq as jax_dq  # noqa: E402
from accelerate_tpu.models.kv_cache import _q as jax_q  # noqa: E402
from accelerate_tpu.ops.flash_attention import (  # noqa: E402
    paged_decode_attention as jax_paged_decode_attention,
)
from accelerate_tpu_torch.models.kv_cache import _dq, _q  # noqa: E402
from accelerate_tpu_torch.ops import _build  # noqa: E402
from accelerate_tpu_torch.ops.flash_attention import (  # noqa: E402
    paged_decode_attention,
    paged_decode_attention_reference,
)

# fp32 throughout: the two sides sum the same products in a different order
# (the interpreter's batched dot_general vs torch's einsum), a few ulp apart;
# 1e-5 leaves two orders of magnitude of margin over that
ATOL = RTOL = 1e-5


def _case(seed, *, b, hq, kvh, d, bt, bps, lengths, quant=False, parked=()):
    r = np.random.default_rng(seed)
    nb = b * bps + 3
    shape = (nb, bt, kvh, d)
    c = {"q": r.standard_normal((b, hq, d)).astype(np.float32)}
    if quant:
        c["k"] = r.integers(-127, 128, shape).astype(np.int8)
        c["v"] = r.integers(-127, 128, shape).astype(np.int8)
        c["ks"] = r.uniform(1e-3, 2e-2, shape[:3]).astype(np.float32)
        c["vs"] = r.uniform(1e-3, 2e-2, shape[:3]).astype(np.float32)
    else:
        c["k"] = r.standard_normal(shape).astype(np.float32)
        c["v"] = r.standard_normal(shape).astype(np.float32)
    tables = r.permutation(nb)[: b * bps].reshape(b, bps).astype(np.int32)
    for i, n in enumerate(lengths):  # unreserved entries hold the sentinel id
        tables[i, -(-max(n, 0) // bt):] = nb
    for i in parked:  # a released slot: its whole row is the sentinel
        tables[i] = nb
    c["tables"] = tables
    c["lengths"] = np.asarray(lengths, np.int32)
    return c


CASES = {
    # block boundaries at 16/17 and a full span
    "fp32_ragged": dict(b=5, hq=2, kvh=2, d=64, bt=16, bps=4, lengths=[1, 16, 17, 64, 33]),
    # a zero-length row (zeros out) and a sentinel-parked row (clamped reads)
    "sentinel_and_empty": dict(b=4, hq=2, kvh=2, d=32, bt=8, bps=4, lengths=[0, 9, 32, 5],
                               parked=(3,)),
    "gqa_groups2": dict(b=3, hq=4, kvh=2, d=64, bt=16, bps=3, lengths=[7, 48, 20]),
    "int8_pool": dict(b=3, hq=2, kvh=2, d=64, bt=8, bps=4, lengths=[3, 8, 30], quant=True),
    "int8_gqa_parked": dict(b=3, hq=4, kvh=2, d=32, bt=8, bps=4, lengths=[12, 1, 20],
                            quant=True, parked=(2,)),
}


def _run_both(c, scale=None):
    jax_out = jax_paged_decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["lengths"]),
        k_scale_pool=jnp.asarray(c["ks"]) if "ks" in c else None,
        v_scale_pool=jnp.asarray(c["vs"]) if "vs" in c else None, scale=scale)
    port_out = paged_decode_attention(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k"]), torch.from_numpy(c["v"]),
        torch.from_numpy(c["tables"]), torch.from_numpy(c["lengths"]),
        k_scale_pool=torch.from_numpy(c["ks"]) if "ks" in c else None,
        v_scale_pool=torch.from_numpy(c["vs"]) if "vs" in c else None, scale=scale)
    return np.asarray(jax_out), port_out.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference_kernel(name):
    c = _case(sum(map(ord, name)), **CASES[name])
    jax_out, port_out = _run_both(c)
    assert port_out.shape == jax_out.shape and port_out.dtype == np.float32
    np.testing.assert_allclose(port_out, jax_out, atol=ATOL, rtol=RTOL)
    # a zero-length row writes zeros, as the reference's zeroed scratch yields
    for i, n in enumerate(c["lengths"]):
        if n <= 0:
            assert not port_out[i].any()


def test_explicit_scale_applies_after_the_dot():
    c = _case(11, **CASES["gqa_groups2"])
    jax_out, port_out = _run_both(c, scale=0.3)
    np.testing.assert_allclose(port_out, jax_out, atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    c = _case(3, **CASES["fp32_ragged"])
    args = [torch.from_numpy(c[k]) for k in ("q", "k", "v", "tables", "lengths")]
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args)
    assert paged_decode_attention.launches == before
    torch.testing.assert_close(out, paged_decode_attention_reference(*args), atol=0, rtol=0)


def test_int8_helpers_match_reference():
    x = np.random.default_rng(5).standard_normal((3, 7, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # all-zero row: scale 1.0, exact zero after dequant
    jq, js = jax_q(jnp.asarray(x))
    tq, ts = _q(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(_dq(tq, ts, torch.float32).numpy(),
                               np.asarray(jax_dq(jq, js, jnp.float32)), rtol=1e-7)


def _bad_args(which):
    c = _case(1, b=2, hq=4, kvh=2, d=32, bt=8, bps=2, lengths=[3, 9], quant=True)
    q, k, v, ks, vs = c["q"], c["k"], c["v"], c["ks"], c["vs"]
    if which == "head_dim":
        q = q[..., :16]
    elif which == "heads":
        q = q[:, :3]
    elif which == "scale_alone":
        vs = None
    elif which == "scale_shape":
        ks = vs = ks[:, :4]
    return q, k, v, c["tables"], c["lengths"], ks, vs


@pytest.mark.parametrize("which,match", [
    ("head_dim", "head_dim"),
    ("heads", "multiple of kv heads"),
    ("scale_alone", "passed together"),
    ("scale_shape", "per-block absmax planes"),
])
def test_validation_mirrors_reference(which, match):
    q, k, v, t, n, ks, vs = _bad_args(which)

    def opt(x, conv):
        return None if x is None else conv(x)

    with pytest.raises(ValueError, match=match) as jax_err:
        jax_paged_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(t),
                                   jnp.asarray(n), k_scale_pool=opt(ks, jnp.asarray),
                                   v_scale_pool=opt(vs, jnp.asarray))
    with pytest.raises(ValueError, match=match) as port_err:
        paged_decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(t), torch.from_numpy(n),
                               k_scale_pool=opt(ks, torch.from_numpy),
                               v_scale_pool=opt(vs, torch.from_numpy))
    assert str(port_err.value) == str(jax_err.value)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
