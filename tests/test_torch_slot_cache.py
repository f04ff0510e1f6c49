"""The port's slot KV cache against the reference's, on the CPU.

`decode_cache_update` is driven on the reference side through a tiny flax
module that owns the ``cache`` collection, from seeded starting buffers, and
on the port side through a `SlotKVCache` holding the same buffers: the
returned views, the buffers and the write index must be equal, bit for bit
(fp32 buffers take copies of the same values; an int8 payload and its fp32
scales come out of the same `_q`). Cases: the scalar index, a start the
reference clamps near ``max_len``, the per-slot index (clamped too), a
frozen row (``write_mask``), ``write_len`` with entries past ``max_len``
dropped, and int8 storage. Then `make_cache`'s shapes and dtypes,
`scatter_cache_slots` (which overwrites the write index), and the byte
counts.
"""

from typing import Any

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
nn = pytest.importorskip("flax.linen")

from accelerate_tpu.models import kv_cache as jkv  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM  # noqa: E402
from accelerate_tpu_torch.models import kv_cache as tkv  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead  # noqa: E402
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM  # noqa: E402

MAX_LEN, KVH, D = 16, 2, 8


class Holder(nn.Module):
    """A flax module whose only state is the reference's decode cache."""

    max_len: int
    kv_cache_dtype: Any = None
    per_slot: bool = False

    @nn.compact
    def __call__(self, k, v, write_mask=None, write_len=None):
        return jkv.decode_cache_update(self, k, v, self.max_len,
                                       kv_cache_dtype=self.kv_cache_dtype,
                                       per_slot=self.per_slot, write_mask=write_mask,
                                       write_len=write_len)


CASES = {
    # name: (b, s, index, write_mask, write_len, int8)
    "scalar": (2, 4, 3, None, None, False),
    "scalar_clamped_near_max_len": (2, 4, 14, None, None, False),
    "scalar_one_token": (3, 1, 9, None, None, False),
    "per_slot": (4, 1, [0, 5, 12, 15], None, None, False),
    "per_slot_clamped": (4, 3, [0, 5, 13, 15], None, None, False),
    "per_slot_frozen_rows": (4, 1, [2, 7, 15, 0], [True, False, True, False], None, False),
    "per_slot_frozen_rows_segment": (4, 3, [2, 7, 14, 0], [True, False, True, True], None, False),
    "write_len_drops_past_max_len": (4, 3, [0, 5, 14, 2], None, [2, 0, 3, 5], False),
    "write_len_with_frozen_row": (4, 3, [1, 5, 15, 9], [True, True, False, True], [3, 1, 3, -2],
                                  False),
    "int8_scalar": (2, 4, 5, None, None, True),
    "int8_per_slot_frozen_rows": (4, 1, [3, 0, 15, 8], [False, True, True, False], None, True),
    "int8_write_len": (3, 2, [4, 15, 1], None, [2, 2, 1], True),
}


def _start(r, b, int8):
    """Seeded starting buffers: what earlier steps left in the cache."""
    if int8:
        kv = [r.integers(-127, 128, (b, MAX_LEN, KVH, D)).astype(np.int8) for _ in range(2)]
        scales = [r.uniform(0.01, 0.1, (b, MAX_LEN, KVH)).astype(np.float32) for _ in range(2)]
        return kv, scales
    return [r.standard_normal((b, MAX_LEN, KVH, D)).astype(np.float32) for _ in range(2)], None


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_cache_update_matches_reference(name):
    b, s, index, write_mask, write_len, int8 = CASES[name]
    r = np.random.default_rng(sorted(CASES).index(name))
    (k0, v0), scales = _start(r, b, int8)
    k, v = (r.standard_normal((b, s, KVH, D)).astype(np.float32) for _ in range(2))
    per_slot = isinstance(index, list)
    idx = np.asarray(index, np.int32)
    mask = None if write_mask is None else np.asarray(write_mask)
    wl = None if write_len is None else np.asarray(write_len, np.int32)

    holder = Holder(MAX_LEN, jnp.int8 if int8 else None, per_slot)
    cache = {"cached_key": jnp.asarray(k0), "cached_value": jnp.asarray(v0),
             "cache_index": jnp.asarray(idx)}
    if int8:
        cache.update(key_scale=jnp.asarray(scales[0]), value_scale=jnp.asarray(scales[1]))
    (k_all, v_all, widx, is_init), mutated = holder.apply(
        {"cache": cache}, jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), None if wl is None else jnp.asarray(wl),
        mutable=["cache"])
    assert is_init
    want = jax.tree.map(np.asarray, mutated["cache"])

    port = tkv.SlotKVCache(
        k=[torch.from_numpy(k0.copy())], v=[torch.from_numpy(v0.copy())],
        index=torch.from_numpy(idx.copy()),
        k_scale=[torch.from_numpy(scales[0].copy())] if int8 else None,
        v_scale=[torch.from_numpy(scales[1].copy())] if int8 else None)
    assert port.per_slot == per_slot and port.quantized == int8
    mask_t = None if mask is None else torch.from_numpy(mask)
    wl_t = None if wl is None else torch.from_numpy(wl)
    got_k, got_v, got_idx = tkv.decode_cache_update(port, 0, torch.from_numpy(k),
                                                    torch.from_numpy(v), mask_t, wl_t)
    got_idx = got_idx.clone()
    tkv.advance_index(port, s, mask_t, wl_t)

    np.testing.assert_array_equal(got_k.numpy(), np.asarray(k_all))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(v_all))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(port.k[0].numpy(), want["cached_key"])
    np.testing.assert_array_equal(port.v[0].numpy(), want["cached_value"])
    np.testing.assert_array_equal(port.index.numpy(), want["cache_index"])
    if int8:
        assert port.k[0].dtype == torch.int8
        np.testing.assert_array_equal(port.k_scale[0].numpy(), want["key_scale"])
        np.testing.assert_array_equal(port.v_scale[0].numpy(), want["value_scale"])
    if mask is not None:  # a frozen row's buffers are its starting bytes
        frozen = ~mask
        np.testing.assert_array_equal(port.k[0].numpy()[frozen], k0[frozen])
        np.testing.assert_array_equal(port.index.numpy()[frozen], idx[frozen])


def test_write_mask_and_write_len_need_a_per_slot_cache():
    cache = tkv.SlotKVCache(k=[torch.zeros(1, 4, 1, 2)], v=[torch.zeros(1, 4, 1, 2)],
                            index=torch.zeros((), dtype=torch.int32))
    new = torch.ones(1, 1, 1, 2)
    for kw, match in ((dict(write_mask=torch.ones(1, dtype=torch.bool)), "write_mask"),
                      (dict(write_len=torch.ones(1, dtype=torch.int32)), "write_len")):
        with pytest.raises(ValueError, match=f"{match} requires per_slot=True"):
            tkv.decode_cache_update(cache, 0, new, new, **kw)
        with pytest.raises(ValueError, match=f"{match} requires per_slot=True") as want:
            Holder(4).apply({"cache": {"cached_key": jnp.zeros((1, 4, 1, 2)),
                                       "cached_value": jnp.zeros((1, 4, 1, 2)),
                                       "cache_index": jnp.int32(0)}},
                            jnp.ones((1, 1, 1, 2)), jnp.ones((1, 1, 1, 2)),
                            **{k: jnp.asarray(t.numpy()) for k, t in kw.items()},
                            mutable=["cache"])
        assert match in str(want.value)


@pytest.mark.parametrize("idx,s,window", [(5, 3, None), (5, 3, 2), ([0, 9, 15], 1, None),
                                          ([4, 0, 12], 2, 3)])
def test_slot_attention_mask_is_the_reference_mask(idx, s, window):
    """The masks the reference's decode branches build: ``[s, max_len]`` for
    a scalar index, ``[b, 1, s, max_len]`` per slot, with Llama's window."""
    i = np.asarray(idx)
    kv_pos = np.arange(MAX_LEN)
    if i.ndim:
        q_pos = i[:, None, None] + np.arange(s)[None, :, None]
        want = (kv_pos[None, None, :] <= q_pos)
        if window:
            want &= kv_pos[None, None, :] > q_pos - window
        want = want[:, None]
    else:
        q_pos = i + np.arange(s)[:, None]
        want = kv_pos[None, :] <= q_pos
        if window:
            want &= kv_pos[None, :] > q_pos - window
    got = tkv.slot_attention_mask(torch.tensor(idx, dtype=torch.int32), s, MAX_LEN, window)
    np.testing.assert_array_equal(got.numpy(), want)


def _ref_layers(cache):
    """The reference cache's per-layer attention dicts, in layer order."""
    names = sorted(cache, key=lambda n: int(n.split("_")[1]))
    return [cache[n]["attn"] for n in names]


@pytest.mark.parametrize("int8", [False, True])
def test_make_cache_shapes_and_dtypes_match_reference(int8):
    kv = dict(kv_cache_dtype=jnp.int8) if int8 else {}
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32, kv_cache_per_slot=True, **kv))
    want = _ref_layers(jkv.make_cache(jmod, 3))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32,
                                       kv_cache_dtype=torch.int8 if int8 else None), device="cpu")
    got = tkv.make_cache(model, 3)
    assert got.per_slot and got.quantized == int8 and len(got.k) == len(want)
    names = ("cached_key", "cached_value") + (("key_scale", "value_scale") if int8 else ())
    for layer, ref in enumerate(want):
        for leaf, name in zip(got.storages(layer), names):
            assert tuple(leaf.shape) == ref[name].shape
            assert str(leaf.dtype).removeprefix("torch.") == str(ref[name].dtype)
            assert not leaf.any()
        assert tuple(got.index.shape) == ref["cache_index"].shape == (3,)
    # Llama's scalar-index cache, GQA kv heads and max_position_embeddings
    jl = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(dtype=jnp.float32, **kv))
    want = jax.eval_shape(lambda: jl.init(jax.random.key(0), jnp.zeros((2, 1), jnp.int32),
                                          decode=True)["cache"])
    llama = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32,
                                              kv_cache_dtype=torch.int8 if int8 else None),
                             device="cpu")
    got = tkv.make_cache(llama, 2, per_slot=False)
    assert not got.per_slot and got.index.ndim == 0
    for layer, ref in enumerate(_ref_layers(want)):
        for leaf, name in zip(got.storages(layer), names):
            assert tuple(leaf.shape) == ref[name].shape
            assert str(leaf.dtype).removeprefix("torch.") == str(ref[name].dtype)


def test_make_cache_refuses_other_kv_dtypes():
    model = GPT2LMHead(GPT2Config.tiny(kv_cache_dtype=torch.float16), device="cpu")
    with pytest.raises(ValueError, match="kv_cache_dtype supports None"):
        tkv.make_cache(model, 2)


@pytest.mark.parametrize("int8", [False, True])
def test_scatter_cache_slots_matches_reference(int8):
    """Fresh rows land at their slots, the other rows keep their bytes, and
    the index of the written slots is OVERWRITTEN with the true lengths."""
    r = np.random.default_rng(11 + int8)
    B, nb, n_layer = 5, 2, 2
    pool = [_start(r, B, int8) for _ in range(n_layer)]
    fresh = [_start(r, nb, int8) for _ in range(n_layer)]
    pool_index = r.integers(0, MAX_LEN, B).astype(np.int32)
    slots = np.asarray([3, 0], np.int32)
    lens = np.asarray([7, 2], np.int32)

    def tree(layers, index):
        out = {}
        for i, ((k, v), sc) in enumerate(layers):
            leaf = {"cached_key": jnp.asarray(k), "cached_value": jnp.asarray(v),
                    "cache_index": jnp.asarray(index)}
            if int8:
                leaf.update(key_scale=jnp.asarray(sc[0]), value_scale=jnp.asarray(sc[1]))
            out[f"block_{i}"] = {"attn": leaf}
        return out

    want = jkv.scatter_cache_slots(tree(pool, pool_index),
                                   tree(fresh, np.full(nb, MAX_LEN, np.int32)),
                                   jnp.asarray(slots), jnp.asarray(lens))

    def port(layers, index):
        t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
        return tkv.SlotKVCache(k=[t(k) for (k, _), _ in layers], v=[t(v) for (_, v), _ in layers],
                               index=t(index),
                               k_scale=[t(sc[0]) for _, sc in layers] if int8 else None,
                               v_scale=[t(sc[1]) for _, sc in layers] if int8 else None)

    got = port(pool, pool_index)
    tkv.scatter_cache_slots(got, port(fresh, np.full(nb, MAX_LEN, np.int32)),
                            torch.from_numpy(slots), torch.from_numpy(lens))
    names = ("cached_key", "cached_value") + (("key_scale", "value_scale") if int8 else ())
    for layer, ref in enumerate(_ref_layers(want)):
        for leaf, name in zip(got.storages(layer), names):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref[name]))
        np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref["cache_index"]))
    assert got.index.tolist() == [2, *pool_index[1:3].tolist(), 7, pool_index[4]]


def test_scatter_cache_slots_writes_a_prefill_bucket_only():
    """Rows shorter than ``max_len`` (an admission's prefill bucket, from
    `SlotKVCache.from_rows`) fill the first positions of their slots; the
    positions past them keep their bytes (masked until decode writes
    them)."""
    r = np.random.default_rng(5)
    pool = tkv.SlotKVCache(k=[torch.from_numpy(r.standard_normal((3, MAX_LEN, KVH, D)))],
                           v=[torch.from_numpy(r.standard_normal((3, MAX_LEN, KVH, D)))],
                           index=torch.zeros(3, dtype=torch.int32))
    before = pool.k[0].clone()
    rows = [(torch.ones(1, 6, KVH, D, dtype=torch.float64),
             torch.full((1, 6, KVH, D), 2.0, dtype=torch.float64))]
    tkv.scatter_cache_slots(pool, tkv.SlotKVCache.from_rows(rows, torch.tensor([4])),
                            torch.tensor([1]), torch.tensor([4]))
    assert (pool.k[0][1, :6] == 1).all() and (pool.v[0][1, :6] == 2).all()
    assert torch.equal(pool.k[0][1, 6:], before[1, 6:])
    assert torch.equal(pool.k[0][[0, 2]], before[[0, 2]])
    assert pool.index.tolist() == [0, 4, 0]


def test_byte_counts_match_reference():
    """`tree_nbytes` and `tree_bytes_by_dtype`: the int8 payload and fp32
    scales are the reference's; the port keeps one int32 index where the
    reference keeps one per layer."""
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32, kv_cache_per_slot=True,
                                            kv_cache_dtype=jnp.int8))
    ref = jkv.make_cache(jmod, 4)
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, kv_cache_dtype=torch.int8),
                       device="cpu")
    got = tkv.make_cache(model, 4)
    want, split = jkv.tree_bytes_by_dtype(ref), tkv.tree_bytes_by_dtype(got)
    assert list(split) == ["float32", "int32", "int8"]
    assert split["int8"] == want["int8"] and split["float32"] == want["float32"]
    n_layer = model.config.n_layer
    assert split["int32"] == want["int32"] // n_layer == 4 * 4
    assert tkv.tree_nbytes(got) == sum(split.values()) == jkv.tree_nbytes(ref) - (n_layer - 1) * 16
