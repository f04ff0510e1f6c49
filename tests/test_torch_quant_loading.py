"""The port's quantized load path against the reference's, on the CPU.

A tiny Llama checkpoint written by the reference (fp16 safetensors, sharded,
as its big-model-inference tool writes one) goes through each package's
``load_and_quantize_model``: the port's packed payloads and scales must equal
the reference's byte for byte, every leaf the reference quantizes quantized
in the port too; the port's model is built on the meta device and filled leaf
by leaf. The quantized Llama's greedy tokens equal a dense Llama's over the
dequantized copy. `quantize_model` swaps a prepared model's layers in place,
and ``quantize_params(on_device=True)`` gives the reference's device pass's
bytes (``device="cpu"`` here: the pass is the same code on the card); the
load quantizes every leaf through that pass.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM  # noqa: E402
from accelerate_tpu.utils import quantization as jq  # noqa: E402
from accelerate_tpu.utils.safetensors_io import save_safetensors_checkpoint  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    LlamaForCausalLM,
    params_from_jax,
)
from accelerate_tpu_torch.utils import quantization as tq  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

MIN_SIZE = 2048  # every projection, embed_tokens and lm_head of the tiny Llama


def _configs(kind):
    kw = dict(load_in_4bit=kind in ("nf4", "fp4"), load_in_8bit=kind == "int8",
              quant_type=kind if kind != "int8" else "nf4", min_weight_size=MIN_SIZE)
    return (jq.QuantizationConfig(compute_dtype=jnp.float32, **kw),
            tq.QuantizationConfig(compute_dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    jmod = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(dtype=jnp.float32, attention_impl="xla"))
    params = jax.tree.map(np.asarray, jax.jit(jmod.init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    half = jax.tree.map(lambda a: a.astype(np.float16), params)
    path = tmp_path_factory.mktemp("llama_fp16")
    save_safetensors_checkpoint(half, path, max_shard_size="100KB")
    return jmod, half, path


def _port_name(path: str) -> str:
    """A reference leaf path (``layer_0/attn/q_proj/kernel``) as the port's
    leaf name (``layers.0.attn.q_proj.weight``)."""
    parts = path.split("/")
    if parts[0].startswith("layer_"):
        return f"layers.{parts[0][6:]}.{parts[1]}.{parts[2]}.weight"
    return parts[0]


def _quantized(tree):
    return {_port_name(jq._flat_path(p)): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jq.QuantizedTensor))[0]
        if isinstance(leaf, jq.QuantizedTensor)}


@pytest.mark.parametrize("kind", ["nf4", "int8", "fp4"])
def test_load_and_quantize_model_matches_reference(checkpoint, kind):
    jmod, _, path = checkpoint
    jcfg, tcfg = _configs(kind)
    _, ref = jq.load_and_quantize_model(jmod, str(path), jcfg)
    want = _quantized(ref)
    meta = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="meta")
    model = tq.load_and_quantize_model(meta, path, tcfg, mapper=params_from_jax, device="cpu")
    assert model is meta and model.device == torch.device("cpu")
    got = {n: leaf for n, leaf in tq.named_leaves(model) if isinstance(leaf, tq.QuantizedTensor)}
    assert set(got) == set(want) and {"embed_tokens", "lm_head"} <= set(got)
    for name, leaf in want.items():
        assert got[name].shape == leaf.shape and got[name].bits == leaf.bits
        np.testing.assert_array_equal(got[name].data.numpy(), np.asarray(leaf.data))
        np.testing.assert_array_equal(got[name].scales.numpy(), np.asarray(leaf.scales))
    assert sum(v.nbytes for v in got.values()) == sum(v.nbytes for v in want.values())
    assert not any(p.is_meta for p in model.parameters())
    # the dense leaves (norm scales) take the model's param dtype; the
    # reference keeps the checkpoint's fp16 there
    assert model.final_norm.scale.dtype == torch.float32


def test_load_and_quantize_model_quantizes_each_leaf_through_the_device_pass(checkpoint,
                                                                            monkeypatch):
    """Every leaf `load_and_quantize_model` quantizes goes through
    `_quantize_leaf_device` (the reference's per-leaf device pass), one leaf a
    call, from host memory to the target device."""
    _, _, path = checkpoint
    _, tcfg = _configs("nf4")
    seen = []
    real = tq._quantize_leaf_device

    def spy(a, block, kind, device):
        seen.append((a.device, torch.device(device), tuple(a.shape)))
        return real(a, block, kind, device)

    monkeypatch.setattr(tq, "_quantize_leaf_device", spy)
    model = tq.load_and_quantize_model(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="meta"), path, tcfg,
        mapper=params_from_jax, device="cpu")
    quantized = [leaf for _, leaf in tq.named_leaves(model) if isinstance(leaf, tq.QuantizedTensor)]
    assert len(seen) == len(quantized) > 0
    assert sorted(shape for *_, shape in seen) == sorted(q.shape for q in quantized)
    assert all(src == torch.device("cpu") and dst == torch.device("cpu") for src, dst, _ in seen)


def test_nf4_llama_greedy_tokens_equal_the_dense_dequantized_copy(checkpoint):
    _, _, path = checkpoint
    _, tcfg = _configs("nf4")
    model = tq.load_and_quantize_model(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="meta"), path, tcfg,
        mapper=params_from_jax, device="cpu")
    dense = tq.dequantize_module(model)
    ids = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 6)))
    np.testing.assert_array_equal(generate(model, ids, 10, device="cpu").numpy(),
                                  generate(dense, ids, 10, device="cpu").numpy())


def test_load_and_quantize_model_refuses_a_mismatched_checkpoint(checkpoint):
    _, _, path = checkpoint
    _, tcfg = _configs("int8")
    bigger = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, num_layers=3), device="meta")
    with pytest.raises(KeyError, match="layers.2"):
        tq.load_and_quantize_model(bigger, path, tcfg, mapper=params_from_jax, device="cpu")
    smaller = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, num_layers=1), device="meta")
    with pytest.raises(ValueError, match="no place for"):
        tq.load_and_quantize_model(smaller, path, tcfg, mapper=params_from_jax, device="cpu")


def test_quantize_model_swaps_a_prepared_model_in_place(checkpoint):
    """`Accelerator.prepare` returns the model; `quantize_model` swaps its
    layers in place, with the same bytes `quantize_module` gives a copy."""
    _, half, _ = checkpoint
    _, tcfg = _configs("nf4")
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(lambda a: a.astype(np.float32), half)))
    prepared, _ = Accelerator(device="cpu").prepare(model, torch.optim.SGD(model.parameters(), 0.1))
    copy = dict(tq.named_leaves(tq.quantize_module(prepared, tcfg)))
    assert tq.quantize_model(prepared, tcfg) is model
    assert isinstance(model.layers[0].attn.q_proj, tq.QuantizedLinear)
    assert isinstance(model.embed_tokens, tq.QuantizedEmbedding) and model.embed_tokens.bare
    for name, leaf in tq.named_leaves(model):
        if isinstance(leaf, tq.QuantizedTensor):
            assert torch.equal(leaf.data, copy[name].data), name
    with pytest.raises(TypeError, match="Cannot quantize"):
        tq.quantize_model((None, {}), tcfg)


@pytest.mark.parametrize("kind", ["nf4", "int8"])
def test_quantize_params_on_device_matches_reference(checkpoint, kind):
    """Leaf by leaf on a device: the reference's jitted device pass and the
    port's `_quantize_leaf_device` give the same payload and scales."""
    _, half, _ = checkpoint
    jcfg, tcfg = _configs(kind)
    ref = jq.quantize_params(half, jcfg, on_device=True)
    flat = {_port_name(jq._flat_path(p)): torch.from_numpy(np.asarray(a))
            for p, a in jax.tree_util.tree_flatten_with_path(half)[0]}
    got = tq.quantize_params(flat, tcfg, on_device=True, device="cpu")
    for name, leaf in _quantized(ref).items():
        np.testing.assert_array_equal(got[name].data.numpy(), np.asarray(leaf.data))
        np.testing.assert_array_equal(got[name].scales.numpy(), np.asarray(leaf.scales))
    assert {n for n, v in got.items() if isinstance(v, tq.QuantizedTensor)} == set(_quantized(ref))
