"""The port's prefix KV cache (`serving.prefix_cache`, the engine's
``prefix_cache=``) against the reference's, on the CPU.

First the trie and block primitives, ported from the reference's own tests:
the gather/scatter round trip, ref-count pins, deterministic leaf-only LRU,
the config refusals and the match cap below the full prompt. Then the
engines: the reference's slot-pool and paged engines with ``prefix_cache``
on the same tiny GPT-2 weights (`params_from_jax`) give the greedy streams
and the prefix counters (hits, tokens reused, blocks donated, evictions)
that the port's slot and paged-gather engines must give, across (depth 1, 2)
x (admit 1, 4) and under eviction pressure. Sampled streams are held port
against port (cache off against on). ``cache_prefix=False`` opts out, and
two in-flight sharers pin the same blocks.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.serving import PagedKVConfig as JaxPagedKVConfig  # noqa: E402
from accelerate_tpu.serving import PrefixCacheConfig as JaxPrefixCacheConfig  # noqa: E402
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JaxServingEngine  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.models.kv_cache import (  # noqa: E402
    BlockAllocator,
    SlotKVCache,
    gather_block_rows,
    make_prefix_block_pool,
    scatter_block_rows,
)
from accelerate_tpu_torch.serving import (  # noqa: E402
    PagedKVConfig,
    PrefixCache,
    PrefixCacheConfig,
    Request,
    SamplingParams,
    ServingEngine,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

BT = 16  # the tiny config's 128 positions are 8 blocks of 16
N_NEW = 8
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_tokens_reused", "prefix_blocks_donated",
            "prefix_evictions")


# ----------------------------------------------------------- the primitives
def _fake_cache(b=2, max_len=16, width=3):
    """A slot cache with distinctive values: one kv head of ``width``."""
    key = torch.arange(b * max_len * width, dtype=torch.float32).reshape(b, max_len, 1, width)
    return SlotKVCache(k=[key], v=[key * 0.5 + 1.0], index=torch.zeros(b, dtype=torch.int32))


def test_block_gather_scatter_roundtrip():
    """scatter_block_rows then gather_block_rows gives the donated slot row
    back bit for bit, drops ids at or past num_blocks (the sink) and stamps
    the resume index."""
    cache = _fake_cache(b=2, max_len=16)
    pool = make_prefix_block_pool(cache, num_blocks=5, block_tokens=4)
    assert pool.k[0].shape == (6, 4, 1, 3) and pool.num_blocks == 5  # the sink block rides along
    scatter_block_rows(pool, cache, 1, torch.tensor([3, 0, 5, 5]))
    row = cache.k[0][1]
    torch.testing.assert_close(pool.k[0][3], row[0:4], rtol=0, atol=0)
    torch.testing.assert_close(pool.k[0][0], row[4:8], rtol=0, atol=0)
    assert not pool.k[0][4].any()  # dropped, untouched
    got = gather_block_rows(pool, torch.tensor([[3, 0, 3, 3]]), torch.tensor([8]))
    torch.testing.assert_close(got.k[0][0, :8], row[:8], rtol=0, atol=0)
    torch.testing.assert_close(got.v[0][0, :8], cache.v[0][1, :8], rtol=0, atol=0)
    assert got.index.tolist() == [8] and got.per_slot


def test_trie_refcount_pins_blocks_against_eviction():
    """Pinned nodes (in-flight sharers) are never evicted; a donation that
    cannot place a block stops without corrupting the trie; release and trim
    drop the pins."""
    cache = _fake_cache(b=1, max_len=16)
    pc = PrefixCache(cache, max_len=16, block_tokens=4, num_blocks=2)
    a = list(range(10))  # 2 full blocks + partial
    assert pc.insert(a, cache, 0) == 2
    m1, m2 = pc.acquire(a), pc.acquire(a)
    assert m1.tokens == m2.tokens == 8 and m1.block_ids == m2.block_ids
    assert all(n.ref == 2 for n in m1.nodes)
    assert pc.insert(list(range(50, 60)), cache, 0) == 0  # full and fully pinned
    assert pc.match_len(a) == 8
    pc.release(m1)
    m2 = pc.trim(m2, 1)
    assert m2.tokens == 4 and m1.nodes[1].ref == 0
    pc.release(m2)
    assert all(n.ref == 0 for n in m1.nodes)
    assert pc.insert(list(range(50, 60)), cache, 0) == 2
    assert pc.match_len(list(range(50, 60))) == 8 and pc.match_len(a) == 0


def test_lru_eviction_is_deterministic_and_leaf_only():
    cache = _fake_cache(b=1, max_len=16)
    pc = PrefixCache(cache, max_len=16, block_tokens=4, num_blocks=3)
    a, b = list(range(9)), list(range(100, 105))
    assert pc.insert(a, cache, 0) == 2
    assert pc.insert(b, cache, 0) == 1
    pc.release(pc.acquire(a))  # refresh A's chain: B is now the LRU leaf
    c = list(range(200, 209))
    assert pc.insert(c, cache, 0) == 2
    assert pc.match_len(b) == 0
    assert pc.match_len(a) == 4
    assert pc.match_len(c) == 8
    assert pc.node_count() == 3 and pc.cached_blocks == 3
    stats = pc.memory_stats()
    assert stats["blocks_resident"] == 3 and stats["blocks_pinned"] == 0
    assert stats["blocks_evictable"] == 2 and stats["blocks_stranded"] == 1


def test_prefix_cache_validates_config():
    cache = _fake_cache(b=1, max_len=16)
    with pytest.raises(ValueError):
        PrefixCache(cache, max_len=16, block_tokens=6)  # not a power of two
    with pytest.raises(ValueError):
        PrefixCache(cache, max_len=10, block_tokens=4)  # does not divide
    with pytest.raises(ValueError):
        PrefixCache(cache, max_len=16, block_tokens=4, num_blocks=0)


def test_match_capped_below_full_prompt():
    cache = _fake_cache(b=1, max_len=16)
    pc = PrefixCache(cache, max_len=16, block_tokens=4, num_blocks=4)
    a = list(range(8))
    pc.insert(a, cache, 0)
    assert pc.match_len(a) == 4  # the last block is held back
    assert pc.match_len(a + [99]) == 8


def test_reclaimable_blocks_walks_a_trie_deeper_than_the_recursion_limit():
    """Llama-3-8B's 8192 positions at block_tokens 8: one cached prompt is a
    1024-level chain, past Python's default recursion limit. The probe
    counts every block of it, less a pinned prefix, and ``reclaim`` frees
    as many by cascading evictions."""
    allocator = BlockAllocator(1100)
    pc = PrefixCache(None, max_len=8192, block_tokens=8, allocator=allocator)
    prompt = np.random.default_rng(5).integers(0, 256, (8192,)).tolist()
    assert pc.adopt(prompt, allocator.alloc(1024), owned_from=0) == 1024
    assert pc.reclaimable_blocks() == 1024
    assert pc.reclaimable_blocks([prompt[:8 * 500] + [1]]) == 1024 - 500
    assert pc.reclaim(2000) == 1024 and allocator.free_count == 1100


def test_engine_refusals():
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="must equal paged_kv block_tokens"):
        ServingEngine(model, device="cpu", paged_kv=PagedKVConfig(block_tokens=16),
                      prefix_cache=PrefixCacheConfig(block_tokens=8))
    pool = ServingEngine(model, device="cpu", max_concurrency=2,
                         prefix_cache=True).prefix_cache.pool
    assert pool.num_blocks == 2 * 2 * (128 // 16)  # the default: twice the slot pool


# ----------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def models():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jmod.init_params(jax.random.key(0))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmod, params, model


def _shared_prefix_prompts(n=8, prefix_len=37, seed=0):
    """Prompts sharing a 37-token prefix (2 full blocks) with distinct tails
    of 3 to 3 + n - 1 tokens (some prompts reach a third full block)."""
    r = np.random.default_rng(seed)
    prefix = r.integers(0, 256, (prefix_len,)).tolist()
    return [prefix + r.integers(0, 256, (3 + i,)).tolist() for i in range(n)]


def _pressure_prompts():
    """Six distinct 36-token prompts, then the first three again: far more
    blocks than a tiny pool holds."""
    r = np.random.default_rng(7)
    prompts = [r.integers(0, 256, (35,)).tolist() + [i] for i in range(6)]
    return prompts + prompts[:3]


def _counters(metrics):
    return {name: getattr(metrics, name).value for name in COUNTERS}


def _jax_run(models, prompts, paged, depth, admit, **kw):
    jmod, params, _ = models
    engine = JaxServingEngine(jmod, params, pipeline_depth=depth, admit_batch=admit,
                              paged_kv=JaxPagedKVConfig(block_tokens=BT, **kw.pop("pool", {}))
                              if paged else False, **kw)
    reqs = [JaxRequest(prompt=list(p), params=JaxSamplingParams(max_new_tokens=N_NEW))
            for p in prompts]
    outs = engine.run(reqs)
    return [o.tokens for o in sorted(outs, key=lambda o: o.request_id)], _counters(engine.metrics)


def _port_run(models, prompts, paged, depth, admit, sampled=False, **kw):
    model = models[2]
    engine = ServingEngine(model, device="cpu", pipeline_depth=depth, admit_batch=admit,
                           paged_kv=PagedKVConfig(block_tokens=BT, **kw.pop("pool", {}))
                           if paged else False, **kw)
    reqs = [Request(prompt=list(p), params=SamplingParams(
                max_new_tokens=N_NEW, temperature=0.8 if sampled and i % 2 else 0.0,
                top_k=5 if sampled and i % 4 == 1 else None, seed=i))
            for i, p in enumerate(prompts)]
    outs = engine.run(reqs)
    return [o.tokens for o in sorted(outs, key=lambda o: o.request_id)], _counters(engine.metrics), \
        engine


ENGINE_KW = dict(max_concurrency=3, prompt_buckets=(8, 16, 64))


@pytest.mark.parametrize("admit", [1, 4])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged_gather"])
def test_streams_and_counters_match_reference(models, paged, depth, admit):
    prompts = _shared_prefix_prompts()
    kw = dict(ENGINE_KW, prefix_cache=JaxPrefixCacheConfig(block_tokens=BT))
    want, want_counts = _jax_run(models, prompts, paged, depth, admit, **kw)
    got, counts, engine = _port_run(models, prompts, paged, depth, admit,
                                    **dict(ENGINE_KW, prefix_cache=PrefixCacheConfig(block_tokens=BT)))
    assert got == want
    assert counts == want_counts
    assert counts["prefix_hits"] > 0 and counts["prefix_blocks_donated"] > 0
    m = engine.metrics
    # the reused tokens were not prefilled; TTFT is split by outcome
    assert m.prefill_tokens.value == sum(len(p) for p in prompts) - m.prefix_tokens_reused.value
    assert m.ttft_hit_s.count == m.prefix_hits.value
    assert m.ttft_miss_s.count == m.prefix_misses.value
    if paged:  # every block is back: the trie's plus the free list
        assert engine._allocator.free_count + engine.prefix_cache.node_count() \
            == engine._allocator.num_blocks


def test_cache_off_streams_equal_the_reference(models):
    prompts = _shared_prefix_prompts()
    want, _ = _jax_run(models, prompts, False, 1, 1, **ENGINE_KW)
    for paged in (False, True):
        assert _port_run(models, prompts, paged, 2, 4, **ENGINE_KW)[0] == want


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged_gather"])
def test_streams_and_counters_match_reference_under_eviction_pressure(models, paged):
    """A pool far too small for the working set keeps evicting: the streams
    stay the reference's, and so do the counters, evictions included. Slot
    mode: a 2-block prefix pool; paged: an 8-block engine pool (one
    full-context slot), where admission reclaims trie leaves."""
    prompts = _pressure_prompts()
    if paged:
        jkw = dict(pool=dict(num_blocks=8), prefix_cache=JaxPrefixCacheConfig(block_tokens=BT))
        kw = dict(pool=dict(num_blocks=8), prefix_cache=PrefixCacheConfig(block_tokens=BT))
    else:
        jkw = dict(prefix_cache=JaxPrefixCacheConfig(block_tokens=BT, num_blocks=2))
        kw = dict(prefix_cache=PrefixCacheConfig(block_tokens=BT, num_blocks=2))
    common = dict(max_concurrency=2, prompt_buckets=(8, 64))
    want, want_counts = _jax_run(models, prompts, paged, 2, 4, **common, **jkw)
    got, counts, engine = _port_run(models, prompts, paged, 2, 4, **common, **kw)
    assert got == want and counts == want_counts
    assert counts["prefix_evictions"] > 0
    if not paged:
        assert engine.prefix_cache.cached_blocks <= 2


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged_gather"])
def test_sampled_streams_equal_with_the_cache_on_and_off(models, paged):
    prompts = _shared_prefix_prompts()
    off = _port_run(models, prompts, paged, 2, 4, sampled=True, **ENGINE_KW)[0]
    on, counts, _ = _port_run(models, prompts, paged, 2, 4, sampled=True,
                              **dict(ENGINE_KW, prefix_cache=True))
    assert on == off and counts["prefix_hits"] > 0


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged_gather"])
def test_cache_prefix_opt_out(models, paged):
    """cache_prefix=False requests neither read nor feed the cache, and
    their streams stay the same."""
    prompts = _shared_prefix_prompts(n=4)
    want = _port_run(models, prompts, paged, 1, 1, **ENGINE_KW)[0]
    engine = ServingEngine(models[2], device="cpu", prefix_cache=True,
                           paged_kv=PagedKVConfig(block_tokens=BT) if paged else False,
                           **ENGINE_KW)
    outs = engine.run([Request(prompt=list(p), params=SamplingParams(max_new_tokens=N_NEW),
                               cache_prefix=False) for p in prompts])
    assert [o.tokens for o in sorted(outs, key=lambda o: o.request_id)] == want
    assert _counters(engine.metrics) == dict.fromkeys(COUNTERS, 0)
    assert engine.prefix_cache.node_count() == 0


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged_gather"])
def test_two_inflight_sharers_pin_the_same_blocks(models, paged):
    """Two requests admitted together off one cached prefix hold the same
    blocks pinned (ref 2) until retirement releases them; paged, both table
    rows alias those blocks."""
    prompts = _shared_prefix_prompts(n=3)
    engine = ServingEngine(models[2], device="cpu", max_concurrency=2, prompt_buckets=(8, 64),
                           admit_batch=2, prefix_cache=PrefixCacheConfig(block_tokens=BT),
                           paged_kv=PagedKVConfig(block_tokens=BT) if paged else False)
    engine.run([Request(prompt=prompts[0], params=SamplingParams(max_new_tokens=16))])
    assert engine.metrics.prefix_blocks_donated.value == 2
    for p in prompts[1:]:
        assert engine.submit(Request(prompt=p, params=SamplingParams(max_new_tokens=16))).accepted
    engine.step()  # admits both sharers off the cached prefix
    pinned = [m for m in engine._slot_match if m is not None]
    assert len(pinned) == 2 and pinned[0].block_ids == pinned[1].block_ids
    assert all(n.ref == 2 for n in pinned[0].nodes)
    if paged:
        rows = engine._d_tables[:, :2].tolist()
        assert rows[0] == rows[1] == list(pinned[0].block_ids)
    while engine.has_work:
        engine.step()
    assert all(m is None for m in engine._slot_match)
    assert all(n.ref == 0 for n in pinned[0].nodes)


def test_stranded_trie_blocks_count_as_capacity_and_the_engine_drains():
    """A paged engine whose pool is held by an unpinned trie chain: 5 free
    blocks, 2 evictable leaves, 9 stranded interior nodes. A fresh request
    needing 10 blocks exceeds free + evictable, and the reference's probe
    (which counts only those) never tries it with no slot active, so
    ``has_work`` stays true forever; the port counts every block a cascade
    of evictions frees, admits it, and drains."""
    torch.manual_seed(0)
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, n_positions=256), device="cpu")
    engine = ServingEngine(model, device="cpu", max_concurrency=1, prompt_buckets=(16, 64, 256),
                           paged_kv=PagedKVConfig(block_tokens=BT, num_blocks=16),
                           prefix_cache=PrefixCacheConfig(block_tokens=BT))
    r = np.random.default_rng(11)
    stem = r.integers(0, 256, (10 * BT,)).tolist()
    branch = stem[:9 * BT] + r.integers(0, 256, (BT,)).tolist()
    one = SamplingParams(max_new_tokens=1)
    engine.run([Request(prompt=stem + [1], params=one)])  # a 10-block chain
    engine.run([Request(prompt=branch + [2], params=one)])  # a leaf beside its tail
    stats = engine.prefix_cache.memory_stats()
    assert (engine._allocator.free_count, stats["blocks_evictable"], stats["blocks_stranded"]) \
        == (5, 2, 9)
    assert engine.prefix_cache.reclaimable_blocks() == 11
    fresh = r.integers(0, 256, (150,)).tolist()
    assert engine._blocks_needed(Request(prompt=fresh, params=SamplingParams(max_new_tokens=10))) \
        == 10
    assert engine.submit(Request(prompt=fresh, params=SamplingParams(max_new_tokens=10))).accepted
    outs = []
    for _ in range(40):
        outs += engine.step()
        if not engine.has_work:
            break
    assert not engine.has_work and len(outs) == 1 and len(outs[0].tokens) == 10
    assert engine.metrics.prefix_evictions.value >= 5
    # its own cached prefix counts as pinned: a request over the stem sees
    # only the branch leaf reclaimable
    assert engine.prefix_cache.reclaimable_blocks([stem + [3]]) < \
        engine.prefix_cache.reclaimable_blocks()
