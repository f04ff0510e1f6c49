"""The port's `utils.quantization` against the reference's.

Quantization is deterministic, so the packed payload and scales must equal the
reference's byte for byte (int8, nf4 and fp4; odd sizes that pad the last
block; an all-zero block), `dequantize` must give the same values, and the
port's eligibility rule must pick the reference's leaves of a tiny GPT-2.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.utils import quantization as jq  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.utils import quantization as tq  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

KINDS = {
    "int8": dict(load_in_8bit=True),
    "nf4": dict(load_in_4bit=True, quant_type="nf4"),
    "fp4": dict(load_in_4bit=True, quant_type="fp4"),
}


def _configs(kind, **kw):
    return (jq.QuantizationConfig(**KINDS[kind], **kw),
            tq.QuantizationConfig(**KINDS[kind], compute_dtype=torch.float32, **kw))


def _weights(shape, seed):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    w.reshape(-1)[:64] = 0.0  # the first block is all zero: scale 1.0
    w.reshape(-1)[64] = 3.5  # an outlier that sets its block's scale
    return w


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("shape,block", [((128, 256), 64), ((37, 45), 64), ((3, 7, 11), 32)])
def test_quantize_bytes_and_dequantize_equal_reference(kind, shape, block):
    w = _weights(shape, seed=len(shape) + block)
    jcfg, tcfg = _configs(kind, block_size=block)
    ref = jq.quantize(w, jcfg)
    got = tq.quantize(torch.from_numpy(w), tcfg)
    assert got.shape == tuple(ref.shape) and got.bits == ref.bits
    want_data = np.asarray(ref.data)
    assert got.data.numpy().dtype == want_data.dtype
    np.testing.assert_array_equal(got.data.numpy(), want_data)
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
    assert got.scales[0].item() == 1.0
    assert got.nbytes == ref.nbytes
    np.testing.assert_array_equal(tq.dequantize(got, torch.float32).numpy(),
                                  np.asarray(jq.dequantize(ref, jnp.float32)))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_from_numpy_carries_reference_tensor_and_rows_gather(kind):
    w = _weights((96, 128), seed=3)
    jcfg, _ = _configs(kind)
    ref = jq.quantize(w, jcfg)
    qt = tq.from_numpy(np.asarray(ref.data), np.asarray(ref.scales), ref.shape, ref.bits,
                       ref.quant_type)
    dense = np.asarray(jq.dequantize(ref, jnp.float32))
    np.testing.assert_array_equal(tq.dequantize(qt).numpy(), dense)
    rows = torch.tensor([[5, 0], [95, 5]])
    np.testing.assert_array_equal(tq.dequantize_rows(qt, rows).numpy(), dense[rows.numpy()])


def _name_map(tree):
    """Reference leaf path ("block_0/attn/qkv/kernel") -> the port's state-dict
    name, read through `params_from_jax` by tagging each leaf with its index."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [np.full(np.shape(leaf), i, np.float32) for i, (_, leaf) in enumerate(leaves)])
    by_tag = {int(t.reshape(-1)[0]): name for name, t in params_from_jax(tagged).items()}
    return {jq._flat_path(path): by_tag[i] for i, (path, _) in enumerate(leaves)}


@pytest.fixture(scope="module")
def tiny():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0)))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return params, model


@pytest.mark.parametrize("kind,skip", [("nf4", []), ("int8", ["mlp"])])
def test_quantized_leaf_set_bytes_and_nbytes_match_reference(tiny, kind, skip):
    params, model = tiny
    jcfg, tcfg = _configs(kind, skip_modules=skip)
    ref = jq.quantize_params(params, jcfg)
    names = _name_map(params)
    ref_leaves = {names[jq._flat_path(p)]: leaf for p, leaf in jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, jq.QuantizedTensor))[0]}
    qmodel = tq.quantize_module(model, tcfg)
    got = dict(tq.named_leaves(qmodel))
    assert set(got) == set(ref_leaves)
    quantized = {n for n, leaf in got.items() if isinstance(leaf, tq.QuantizedTensor)}
    assert quantized == {n for n, leaf in ref_leaves.items() if isinstance(leaf, jq.QuantizedTensor)}
    assert "wte.weight" in quantized and "blocks.0.attn.qkv.weight" in quantized
    assert ("blocks.0.mlp.up.weight" in quantized) == (not skip)
    for n in quantized:
        np.testing.assert_array_equal(got[n].data.numpy(), np.asarray(ref_leaves[n].data))
        np.testing.assert_array_equal(got[n].scales.numpy(), np.asarray(ref_leaves[n].scales))
    assert tq.quantized_nbytes(qmodel) == jq.quantized_nbytes(ref)
    # the caller's model is untouched; dense leaves are shared
    assert isinstance(model.wte, torch.nn.Embedding) and isinstance(model.blocks[0].attn.qkv,
                                                                    torch.nn.Linear)
    assert qmodel.blocks[0].attn.qkv.bias is model.blocks[0].attn.qkv.bias
    # and the flat-dict transform agrees with the module one
    flat = tq.quantize_params(dict(tq.named_leaves(model)), tcfg)
    assert {n for n, v in flat.items() if isinstance(v, tq.QuantizedTensor)} == quantized
    dense = tq.dequantize_module(qmodel)
    deq = jq.dequantize_params(ref, jnp.float32)
    for name, t in params_from_jax(jax.tree.map(np.asarray, deq)).items():
        np.testing.assert_array_equal(dense.state_dict()[name].numpy(), t.numpy())


def test_config_errors_match_reference():
    for kw in (dict(), dict(load_in_8bit=True, load_in_4bit=True),
               dict(load_in_4bit=True, quant_type="int4")):
        with pytest.raises(ValueError) as want:
            jq.QuantizationConfig(**kw)
        with pytest.raises(ValueError) as got:
            tq.QuantizationConfig(**kw)
        assert str(got.value) == str(want.value)


def test_quantize_module_refuses_other_eligible_params():
    class Odd(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.table = torch.nn.Parameter(torch.ones(64, 128))

    holder = torch.nn.Sequential(Odd())
    with pytest.raises(TypeError, match="cannot quantize"):
        tq.quantize_module(holder, tq.QuantizationConfig(load_in_8bit=True))
