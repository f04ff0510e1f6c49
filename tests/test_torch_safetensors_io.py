"""The port's safetensors reader and writer against the reference's, on the CPU.

The port writes the format by hand (no ``safetensors`` or ``ml_dtypes``
package on the card's machine); each package must load what the other wrote,
byte for byte: fp32, fp16 and bf16 leaves (bf16 crosses as torch's own dtype
on the port's side and as ml_dtypes' on the reference's), integer and bool
leaves, one file or shards with ``model.safetensors.index.json`` (the same
index the reference writes), and tied weights saved once. Then the loaders:
`load_checkpoint_in_model` puts a reference-written GPT-2 or Llama
checkpoint into the port's module through its ``params_from_jax``, and
`checkpointing.load_model_weights` reads an export and refuses flax's
msgpack.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
ml_dtypes = pytest.importorskip("ml_dtypes")

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM  # noqa: E402
from accelerate_tpu.utils import safetensors_io as ref  # noqa: E402
from accelerate_tpu_torch import checkpointing  # noqa: E402
from accelerate_tpu_torch.models import gpt2, llama  # noqa: E402
from accelerate_tpu_torch.utils import safetensors_io as port  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _tree(seed=0):
    """A nested state dict with every dtype the two packages exchange."""
    r = np.random.default_rng(seed)
    return {
        "block_0": {"attn": {"kernel": r.standard_normal((8, 12)).astype(np.float32),
                             "bias": r.standard_normal(12).astype(np.float16)},
                    "scale": r.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)},
        "block_1": {"kernel": r.standard_normal((16, 4)).astype(np.float16)},
        "steps": np.arange(6, dtype=np.int32),
        "ids": np.arange(-3, 3, dtype=np.int64),
        "payload": r.integers(-127, 128, 40).astype(np.int8),
        "mask": r.integers(0, 2, 9).astype(bool),
    }


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _raw(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return np.ascontiguousarray(t).tobytes()


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("shard", ["10GB", 200])
def test_reference_writes_and_port_reads(tmp_path, shard):
    tree = _tree()
    ref.save_safetensors_checkpoint(tree, tmp_path, max_shard_size=shard)
    got = port.load_safetensors_checkpoint(tmp_path)
    want = ref.flatten_state_dict(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        assert _dtype_name(got[k]) == str(v.dtype) and tuple(got[k].shape) == v.shape, k
        assert _raw(got[k]) == _raw(v), k
    nested = port.load_safetensors_checkpoint(tmp_path, nested=True)
    assert torch.equal(nested["block_0"]["attn"]["kernel"], got["block_0.attn.kernel"])


@pytest.mark.parametrize("shard", ["10GB", 200])
def test_port_writes_and_reference_reads(tmp_path, shard):
    flat = {k: _to_torch(v) for k, v in ref.flatten_state_dict(_tree(1)).items()}
    written = port.save_safetensors_checkpoint(port.unflatten_state_dict(flat), tmp_path,
                                               max_shard_size=shard)
    assert (len(written) == 1) == (shard == "10GB")  # else shards and the index
    got = ref.load_safetensors_checkpoint(tmp_path)
    assert set(got) == set(flat)
    for k, v in flat.items():
        assert str(np.asarray(got[k]).dtype) == _dtype_name(v) and got[k].shape == tuple(v.shape)
        assert _raw(got[k]) == _raw(v), k
    # the format's own reader takes each file the port wrote
    from safetensors import safe_open

    for f in (p for p in written if p.endswith(".safetensors")):
        with safe_open(f, framework="np") as handle:
            assert handle.metadata()["format"] == "pt"


def test_sharding_and_index_file_match_reference(tmp_path):
    tree = _tree(2)
    ref.save_safetensors_checkpoint(tree, tmp_path / "ref", max_shard_size=200)
    flat = {k: _to_torch(v) for k, v in ref.flatten_state_dict(tree).items()}
    port.save_safetensors_checkpoint(flat, tmp_path / "port", max_shard_size=200)
    index = port.SAFE_WEIGHTS_INDEX_NAME
    want = json.loads((tmp_path / "ref" / index).read_text())
    got = json.loads((tmp_path / "port" / index).read_text())
    assert got == want
    assert got["metadata"]["total_size"] == sum(len(_raw(v)) for v in flat.values())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "ref").iterdir())


def test_tied_weights_saved_once_both_ways(tmp_path):
    r = np.random.default_rng(3)
    emb = r.standard_normal((32, 8)).astype(np.float32)
    # reference side: one array under two names
    ref.save_safetensors_checkpoint({"wte": emb, "head": emb, "b": np.ones(3, np.float32)},
                                    tmp_path / "ref", max_shard_size=800)
    got = port.load_safetensors_checkpoint(tmp_path / "ref")
    assert got["head"] is got["wte"] and _raw(got["wte"]) == _raw(emb)
    # port side: one tensor under two names, as a tied module's state dict has
    t = torch.from_numpy(emb.copy())
    written = port.save_safetensors_checkpoint({"wte": t, "head": t, "b": torch.ones(3)},
                                               tmp_path / "port", max_shard_size=800)
    meta = json.loads((tmp_path / "port" / port.SAFE_WEIGHTS_INDEX_NAME).read_text())["metadata"]
    assert json.loads(meta["tied_weights"]) == {"head": "wte"}
    assert sum("head" in port.load_file(f) for f in written if f.endswith(".safetensors")) == 0
    back = ref.load_safetensors_checkpoint(tmp_path / "port")
    assert _raw(back["head"]) == _raw(emb) and back["head"] is back["wte"]
    # two different views of one buffer are not tied
    qkv = torch.arange(12.0)
    assert port.find_tied_weights({"q": qkv[:4], "k": qkv[4:8], "q2": qkv[:4]}) == {"q2": "q"}


def test_load_checkpoint_in_model_takes_a_reference_gpt2_checkpoint(tmp_path):
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0)))
    ref.save_safetensors_checkpoint(params, tmp_path, max_shard_size="50KB")
    model = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(dtype=torch.float32), device="cpu", seed=5)
    port.load_checkpoint_in_model(model, tmp_path, mapper=gpt2.params_from_jax)
    want = gpt2.params_from_jax(params)
    for name, t in model.state_dict().items():
        assert torch.equal(t, want[name]), name
    with pytest.raises(RuntimeError, match="Missing key"):
        port.load_checkpoint_in_model(model, tmp_path)  # the reference's names, no mapper


def test_load_checkpoint_in_model_casts_a_reference_llama_fp16_checkpoint(tmp_path):
    """An fp16 checkpoint (the big-model-inference tool's) into a bf16 Llama:
    each tensor is cast into the parameter's dtype."""
    jmod = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(dtype=jnp.float32, attention_impl="xla"))
    params = jax.tree.map(np.asarray, jax.jit(jmod.init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    half = jax.tree.map(lambda a: a.astype(np.float16), params)
    ref.save_safetensors_checkpoint(half, tmp_path, max_shard_size="100KB")
    model = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(param_dtype=torch.bfloat16),
                                   device="cpu")
    port.load_checkpoint_in_model(model, tmp_path, mapper=llama.params_from_jax)
    want = llama.params_from_jax(jax.tree.map(lambda a: a.astype(np.float32), half))
    for name, t in model.state_dict().items():
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, want[name].to(torch.bfloat16)), name


def test_load_model_weights_reads_safetensors_and_refuses_msgpack(tmp_path):
    tree = _tree(4)
    ref.save_safetensors_checkpoint(tree, tmp_path / "st")
    got = checkpointing.load_model_weights(tmp_path / "st")
    assert _raw(got["block_1"]["kernel"]) == _raw(tree["block_1"]["kernel"])
    (tmp_path / "mp").mkdir()
    (tmp_path / "mp" / "model.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="msgpack"):
        checkpointing.load_model_weights(tmp_path / "mp")
    with pytest.raises(FileNotFoundError):
        port.load_safetensors_checkpoint(tmp_path / "missing")


def test_unaligned_tensors_and_dtype_cast(tmp_path):
    """A file whose tensors do not start at multiples of their element size
    still reads; ``dtype=`` casts only the floating tensors."""
    import struct

    a = np.arange(3, dtype=np.int8)
    b = np.arange(4, dtype=np.float32)
    header = {"a": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [4], "data_offsets": [3, 19]}}
    raw = json.dumps(header).encode()
    path = tmp_path / "x.safetensors"
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + a.tobytes() + b.tobytes())
    got = port.load_file(path, dtype=torch.float16)
    assert got["a"].dtype == torch.int8 and got["a"].tolist() == [0, 1, 2]
    assert got["b"].dtype == torch.float16 and got["b"].tolist() == [0.0, 1.0, 2.0, 3.0]
