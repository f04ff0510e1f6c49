"""The port's host-RAM KV tier and request hibernation (`serving.kv_tier`,
the engine's ``kv_tier=``) against the reference's, on the CPU.

The reference's own tests (`tests/test_kv_tier.py`) carried across: the wake
cost model and the config refusals; spill picks the LRU unpinned leaf (the
same victims, in the same order, as the reference's trie) and keeps
device-backed implies parent device-backed; page-in is all or nothing;
hibernation victims come coldest first under an injected clock; a cancel
reaches a hibernated record and the host ledger drains. Then the engines, on
the same tiny fp32 GPT-2 weights (`params_from_jax`): the parity matrix over
``paged_attention`` gather/fused x depth 1/2 (a forced mid-decode
hibernate -> wake of every active slot, then a whole-trie spill and a replay
whose hits page in), where the port's tier-on greedy streams equal the
reference's tier-on streams and the port's tier-off streams, each reference
stream clear of near-ties; both wake policies (greedy against the reference,
sampled port against port tier-off); pressure spill then admit; a crash
mid-spill resumed from the journal; an int8 pool (tier-on against tier-off);
and the ``host_tier/*`` counters, `memory_stats` keys and
`capacity_headroom` against the reference's for the same run. The reference
engines see every dispatch ready at their reap, as the port's CPU engine
does.
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
from accelerate_tpu.serving.kv_tier import KVTierConfig as JaxKVTierConfig  # noqa: E402
from accelerate_tpu.serving.kv_tier import choose_wake as jax_choose_wake  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    KVTier,
    KVTierConfig,
    PagedKVConfig,
    PrefixCacheConfig,
    Request,
    RequestJournal,
    SamplingParams,
    ServingEngine,
    choose_wake,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

BT = 16  # the tiny config's 128 positions are 8 blocks of 16
MIN_MARGIN = 1e-3  # as in the cluster tests: a smaller top-2 gap is a near-tie
PKG = {
    "jax": dict(Request=JaxRequest, SamplingParams=JaxSamplingParams, Paged=JaxPagedKVConfig,
                Prefix=JaxPrefixCacheConfig, Tier=JaxKVTierConfig),
    "torch": dict(Request=Request, SamplingParams=SamplingParams, Paged=PagedKVConfig,
                  Prefix=PrefixCacheConfig, Tier=KVTierConfig),
}


@pytest.fixture(scope="module")
def models():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jmod.init_params(jax.random.key(0))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmod, params, model


def _engine(models, pkg, *, tier=None, prefix=False, num_blocks=None, **kw):
    """A paged engine of either package; ``tier`` is a dict of tier config
    fields (``{}`` for the default tier) or None for tier-off."""
    p = PKG[pkg]
    common = dict(paged_kv=p["Paged"](block_tokens=BT, num_blocks=num_blocks), **kw)
    if prefix:
        common["prefix_cache"] = p["Prefix"](block_tokens=BT)
    if tier is not None:
        common["kv_tier"] = p["Tier"](**tier)
    jmod, params, model = models
    if pkg == "torch":
        return ServingEngine(model, device="cpu", **common)
    engine = JaxServingEngine(jmod, params, **common)

    def reap(finished):
        while engine._inflight:
            engine._process_oldest(finished)
    engine._reap_ready = reap
    return engine


def _prompts(seed, lengths, vocab=256):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, (n,)).tolist() for n in lengths]


def _requests(pkg, prompts, n_new=10, greedy=True):
    p = PKG[pkg]
    return [p["Request"](prompt=list(x), params=p["SamplingParams"](
                max_new_tokens=n_new, temperature=0.0 if greedy else 0.8,
                top_k=None if greedy else 7, seed=i))
            for i, x in enumerate(prompts)]


def _conservation(engine):
    """The device and host ledgers, at every transition."""
    mem = engine.memory_stats()
    assert (mem["block_pool/blocks_free"] + mem["block_pool/blocks_resident"]
            + mem["block_pool/blocks_private"] == mem["block_pool/blocks_total"])
    assert mem["host_tier/bytes"] == mem["host_tier/blocks"] * mem["host_tier/block_bytes"]
    return mem


def _drain(engine, outs, force_hibernate=False, trail=None):
    """Step to empty, collecting ``{rid: tokens}``. With ``force_hibernate``
    every active slot is parked the first time one has >= 2 tokens.
    ``trail`` collects ``(memory_stats, capacity_headroom)`` after each step
    (``device*`` keys dropped, as the CPU has none)."""
    forced = not force_hibernate
    while engine.has_work:
        for o in engine.step():
            outs[o.request_id] = o.tokens
        if not forced:
            ready = [int(s) for s in np.flatnonzero(engine._active)
                     if engine._slot_out[s] is not None and len(engine._slot_out[s].tokens) >= 2]
            if ready:
                for s in ready:
                    engine.kv_tier.hibernate_slot(s)
                forced = True
        if engine.kv_tier is not None:
            mem = _conservation(engine)
            if trail is not None:
                head = engine.capacity_headroom()
                head.pop("decode_tokens_per_sec")
                head.pop("seconds_to_exhaustion")
                head.pop("est_slot_free_s")
                trail.append(({k: v for k, v in mem.items() if not k.startswith("device")}, head))
    assert forced, "hibernation was never forced: the scenario proves nothing"
    return outs


def _assert_clear_of_ties(models, prompts, outs):
    """Each reference greedy stream's every step has a top-2 logit gap above
    MIN_MARGIN (one batched causal forward over prompt + stream)."""
    jmod, params, _ = models
    rows = [p + outs[i][:-1] for i, p in enumerate(prompts)]
    ids = np.zeros((len(rows), max(map(len, rows))), np.int32)
    for i, row in enumerate(rows):
        ids[i, :len(row)] = row
    logits = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids)))
    for i, p in enumerate(prompts):
        top2 = np.sort(logits[i, len(p) - 1:len(rows[i])], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MIN_MARGIN, f"near-tie in reference stream {i}"


# ------------------------------------------------------------ cost model
@pytest.mark.parametrize("host_bytes", [0, 1000, 10**6, 10**9])
@pytest.mark.parametrize("replay", [1, 10, 100, 10_000])
def test_choose_wake_equals_the_reference_on_a_grid(host_bytes, replay):
    for up in (0.0, 1e3, 1e6, 1e9):
        for tps in (0.0, 1.0, 10.0, 1e6):
            assert choose_wake(host_bytes, replay, up, tps) == jax_choose_wake(
                host_bytes, replay, up, tps)


def test_choose_wake_cost_model():
    """Upload wins exactly when restoring host bytes beats replaying; an
    unmeasured rate (or nothing on host) means prefill; a tie means
    prefill."""
    assert choose_wake(1000, 100, 1e6, 10.0) == "upload"
    assert choose_wake(10**9, 10, 1e3, 1e6) == "prefill"
    assert choose_wake(1000, 100, 0.0, 10.0) == "prefill"
    assert choose_wake(1000, 100, 1e6, 0.0) == "prefill"
    assert choose_wake(0, 100, 1e6, 10.0) == "prefill"
    assert choose_wake(1000, 10, 100.0, 1.0) == "prefill"


def test_config_validation(models):
    for pkg in ("torch", "jax"):
        tier = PKG[pkg]["Tier"]
        with pytest.raises(ValueError, match="wake_policy"):
            tier(wake_policy="teleport")
        with pytest.raises(ValueError, match="min_resident_slots"):
            tier(min_resident_slots=-1)
        with pytest.raises(ValueError, match="thrash_enter_events"):
            tier(thrash_enter_events=0)
    assert KVTierConfig() == KVTierConfig(**{
        f: getattr(JaxKVTierConfig(), f) for f in KVTierConfig.__dataclass_fields__})
    messages = []
    for pkg in ("torch", "jax"):
        with pytest.raises(ValueError, match="requires paged_kv") as exc:
            if pkg == "torch":
                ServingEngine(models[2], device="cpu", max_concurrency=2, prompt_buckets=(16,),
                              kv_tier=True)
            else:
                JaxServingEngine(models[0], models[1], max_concurrency=2, prompt_buckets=(16,),
                                 kv_tier=True)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------- spill ordering
def _trie_paths(pc):
    """Every trie node by its key path (token tuples from the root)."""
    out, stack = {}, [(c, (c.key,)) for c in pc._root.children.values()]
    while stack:
        node, path = stack.pop()
        out[node] = path
        stack.extend((c, path + (c.key,)) for c in node.children.values())
    return out


def test_trie_spill_victims_equal_the_reference_and_keep_the_invariant(models):
    """After the same traffic, both tries spill the same blocks in the same
    (LRU) order, one at a time, and device-backed implies parent
    device-backed after each spill."""
    prompts = _prompts(23, (40, 40, 21, 9))
    prompts[1] = list(prompts[0])  # a shared prefix: a multi-level chain
    orders = {}
    for pkg in ("torch", "jax"):
        engine = _engine(models, pkg, tier={}, prefix=True, num_blocks=48, max_concurrency=4,
                         prompt_buckets=(16, 64), admit_batch=4)
        for o in engine.run(_requests(pkg, prompts)):
            assert o.tokens
        pc, tier = engine.prefix_cache, engine.kv_tier
        order = []
        while True:
            paths = _trie_paths(pc)
            victim = tier._spill_victim()
            if victim is None:
                assert tier.page_out_trie(1) == 0
                break
            assert tier.page_out_trie(1) == 1
            order.append(paths[victim])
            stack = [(pc._root, True)]
            while stack:
                node, parent_backed = stack.pop()
                if node is not pc._root and node.block_id is not None:
                    assert parent_backed, "device-backed node under a spilled parent"
                backed = node is pc._root or node.block_id is not None
                stack.extend((c, backed) for c in node.children.values())
            _conservation(engine)
        assert order and tier.trie_host_blocks == len(order)
        assert int(engine.metrics.host_page_outs.value) == len(order)
        orders[pkg] = order
    assert orders["torch"] == orders["jax"]


def test_page_in_is_all_or_nothing(models):
    """A page-in that cannot allocate changes nothing (no gauge moves, the
    host copy stays, the node stays hit-able); the retry restores the block
    bit for bit."""
    engine = _engine(models, "torch", tier={}, prefix=True, num_blocks=24, max_concurrency=2,
                     prompt_buckets=(16, 64))
    tier = engine.kv_tier
    for o in engine.run(_requests("torch", _prompts(29, (40, 21)))):
        assert o.tokens
    victim = tier._spill_victim()
    assert victim is not None
    before_bytes = [leaf[victim.block_id].clone() for leaf in tier.leaves()]
    tier._spill_node(victim)
    assert victim.block_id is None and tier.trie_host_blocks == 1

    hog = engine._allocator.alloc(engine._allocator.free_count)
    before = (_conservation(engine), tier.memory_stats())
    assert tier.page_in_node(victim) is False
    assert (_conservation(engine), tier.memory_stats()) == before
    assert victim.block_id is None and tier.trie_blocks.get(victim) is not None

    engine._allocator.free(hog)
    assert tier.page_in_node(victim) is True
    assert victim.block_id is not None and tier.trie_host_blocks == 0
    assert int(engine.metrics.host_page_ins.value) == 1
    for leaf, want in zip(tier.leaves(), before_bytes):
        assert torch.equal(leaf[victim.block_id], want)
    assert tier.uploads_in_flight == 0  # the CPU copy is done at once
    _conservation(engine)


def test_corrupt_host_copy_is_refused(models):
    """A page-in re-hashes the host bytes: one flipped byte raises and
    leaves the allocator as it was."""
    engine = _engine(models, "torch", tier={}, prefix=True, num_blocks=24, max_concurrency=2,
                     prompt_buckets=(16, 64))
    tier = engine.kv_tier
    engine.run(_requests("torch", _prompts(29, (40, 21))))
    victim = tier._spill_victim()
    tier._spill_node(victim)
    tier.trie_blocks.get(victim).buf[0] ^= 1
    free = engine._allocator.free_count
    with pytest.raises(RuntimeError, match="content hash mismatch"):
        tier.page_in_node(victim)
    assert engine._allocator.free_count == free and victim.block_id is None


# ------------------------------------------------------ hibernation policy
def test_hibernation_victim_ordering_equals_the_reference(models):
    """Coldest first under an injected clock: long-idle slots by descending
    idleness, then the rest in arrival order; a slot inside its wake
    cooldown is exempt. Both packages order the same slots alike."""
    got = {}
    for pkg in ("torch", "jax"):
        engine = _engine(models, pkg, tier=dict(hibernate_idle_s=30.0, wake_cooldown_s=10.0),
                         max_concurrency=3, prompt_buckets=(16,), admit_batch=3)
        tier = engine.kv_tier
        for r in _requests(pkg, _prompts(31, (6, 7, 8)), n_new=20):
            assert engine.submit(r).accepted
        for _ in range(4):
            engine.step()
        slots = [int(s) for s in np.flatnonzero(engine._active)]
        assert len(slots) == 3 and all(engine._slot_out[s].tokens for s in slots)
        for s, arrival in zip(slots, (1.0, 2.0, 3.0)):
            engine._slot_req[s].arrival_time = arrival
        now = 1000.0
        engine._slot_last_token_t[slots[0]] = now - 1.0    # fresh
        engine._slot_last_token_t[slots[1]] = now - 2.0    # fresh, later arrival
        engine._slot_last_token_t[slots[2]] = now - 100.0  # long idle
        orders = [tier._victims(now)]
        assert orders[0] == [slots[2], slots[0], slots[1]]
        engine._slot_last_token_t[slots[1]] = now - 50.0   # long idle, but less
        orders.append(tier._victims(now))
        assert orders[1] == [slots[2], slots[1], slots[0]]
        tier._wake_t[engine._slot_req[slots[0]].request_id] = now - 1.0  # in cooldown
        orders.append(tier._victims(now))
        assert orders[2] == [slots[2], slots[1]]
        got[pkg] = [[engine._slot_req[s].request_id for s in order] for order in orders]
    assert got["torch"] == got["jax"]


def test_hibernated_cancel_and_ledger_drain(models):
    """Cancel reaches a hibernated record: the terminal carries the parked
    tokens and the host ledger drains to zero; the survivor finishes."""
    engine = _engine(models, "torch", tier={}, max_concurrency=2, prompt_buckets=(16,),
                     admit_batch=2)
    tier = engine.kv_tier
    for r in _requests("torch", _prompts(37, (6, 9)), n_new=16):
        assert engine.submit(r).accepted
    for _ in range(4):
        engine.step()
    slot = next(int(s) for s in np.flatnonzero(engine._active) if engine._slot_out[int(s)].tokens)
    rid = engine._slot_req[slot].request_id
    parked = list(engine._slot_out[slot].tokens)
    assert tier.hibernate_slot(slot) > 0
    assert tier.hibernated_count == 1 and tier.host_blocks > 0
    _conservation(engine)
    out = engine.cancel(rid)
    assert out is not None and out.tokens == parked and out.finish_reason == "aborted"
    assert tier.hibernated_count == 0 and tier.host_blocks == 0
    assert _conservation(engine)["host_tier/bytes"] == 0
    assert engine.cancel(rid) is None
    while engine.has_work:
        engine.step()
    assert engine._allocator.free_count == engine._allocator.num_blocks


def test_abort_all_and_snapshot_carry_hibernated_streams(models, tmp_path):
    """A hibernated stream snapshots as an admitted entry with its parked
    tokens, and `abort_all` returns it after the queue and before the active
    slots, as the reference's does."""
    outs = {}
    for pkg in ("torch", "jax"):
        engine = _engine(models, pkg, tier={}, max_concurrency=2, prompt_buckets=(16,),
                         admit_batch=2)
        for r in _requests(pkg, _prompts(37, (6, 9, 7)), n_new=16):
            assert engine.submit(r).accepted
        for _ in range(4):
            engine.step()
        slot = min(int(s) for s in np.flatnonzero(engine._active))
        engine.kv_tier.hibernate_slot(slot)
        engine.snapshot(tmp_path / f"{pkg}.snap")
        snap = __import__("json").loads((tmp_path / f"{pkg}.snap").read_text())
        outs[pkg] = ([(e["rid"], e["toks"], e["admitted"]) for e in snap["entries"]],
                     [(o.request_id, o.tokens, o.finish_reason) for o in engine.abort_all()])
        assert engine.kv_tier.hibernated_count == 0
    assert outs["torch"] == outs["jax"]


# ------------------------------------------------------------------ parity
@pytest.fixture(scope="module")
def tier_prompts():
    return _prompts(11, (5, 21, 40, 9))


@pytest.fixture(scope="module")
def tier_off(models, tier_prompts):
    """The port's tier-off greedy streams: the parity oracle."""
    engine = _engine(models, "torch", prefix=True, num_blocks=48, max_concurrency=4,
                     prompt_buckets=(16, 64), admit_batch=4)
    return {o.request_id: o.tokens for o in engine.run(_requests("torch", tier_prompts))}


def _parity_run(models, pkg, prompts, pa, depth):
    """A forced mid-decode hibernate -> wake of every active slot, then the
    whole trie spilled and the same prompts replayed (their hits page in)."""
    kw = dict(max_concurrency=4, prompt_buckets=(16, 64), pipeline_depth=depth, admit_batch=4,
              paged_attention=pa)
    engine = _engine(models, pkg, tier=dict(wake_policy="upload"), prefix=True, num_blocks=48,
                     **kw)
    for r in _requests(pkg, prompts):
        assert engine.submit(r).accepted
    trail = []
    first = _drain(engine, {}, force_hibernate=True, trail=trail)
    m = engine.metrics
    assert int(m.host_hibernated.value) >= 1 and int(m.host_wakeups.value) >= 1
    spilled = engine.kv_tier.page_out_trie(64)
    page_ins = int(m.host_page_ins.value)
    replay = _requests(pkg, prompts)
    for r in replay:
        assert engine.submit(r).accepted
    outs = _drain(engine, {}, trail=trail)
    second = [outs[r.request_id] for r in replay]
    assert int(m.host_page_ins.value) > page_ins
    return dict(first=first, second=second, spilled=spilled, trail=trail,
                counters={k: int(getattr(m, f"host_{k}").value) for k in
                          ("page_ins", "page_outs", "hibernated", "wakeups", "thrash_events")},
                hists=(m.host_page_in_s.count, m.host_page_out_s.count),
                mem=engine.memory_stats())


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("pa", ["gather", "fused"])
def test_tier_parity_matrix(models, tier_prompts, tier_off, pa, depth):
    """Tier-on port == tier-on reference == tier-off port, greedy, through a
    forced hibernate -> upload wake of every active slot and a whole-trie
    spill -> page-in replay; the counters, the ``host_tier/*`` gauges, the
    memory and headroom keys after every step equal the reference's."""
    got = _parity_run(models, "torch", tier_prompts, pa, depth)
    want = _parity_run(models, "jax", tier_prompts, "gather", depth)
    refs = [tier_off[i] for i in range(len(tier_prompts))]
    _assert_clear_of_ties(models, tier_prompts, refs)
    assert got["first"] == want["first"] == tier_off
    assert got["second"] == want["second"] == refs
    assert got["spilled"] == want["spilled"] > 0
    assert got["counters"] == want["counters"] and got["hists"] == want["hists"]
    assert len(got["trail"]) == len(want["trail"])
    for (mem, head), (ref_mem, ref_head) in zip(got["trail"], want["trail"]):
        assert set(mem) == set(ref_mem)
        assert {k: v for k, v in mem.items() if k.startswith("host_tier/")} == \
            {k: v for k, v in ref_mem.items() if k.startswith("host_tier/")}
        assert head == ref_head
    assert got["mem"]["host_tier/hibernated"] == 0 and got["mem"]["host_tier/spill_frozen"] == 0


@pytest.mark.parametrize("policy", ["upload", "prefill"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_hibernate_wake_both_policies(models, policy, greedy):
    """Both wake paths resume a half-decoded stream exactly: greedy streams
    equal the reference's tier-on run and the port's tier-off run; sampled
    ones the port's tier-off run (generators are the port's own). Only an
    upload wake pages in (no prefix cache here)."""
    prompts = _prompts(13, (5, 18, 33))
    kw = dict(max_concurrency=3, prompt_buckets=(16, 64), pipeline_depth=2, admit_batch=3)
    off = _engine(models, "torch", **kw)
    want = {o.request_id: o.tokens
            for o in off.run(_requests("torch", prompts, n_new=12, greedy=greedy))}
    runs = {}
    for pkg in ("torch", "jax") if greedy else ("torch",):
        on = _engine(models, pkg, tier=dict(wake_policy=policy), **kw)
        for r in _requests(pkg, prompts, n_new=12, greedy=greedy):
            assert on.submit(r).accepted
        runs[pkg] = (_drain(on, {}, force_hibernate=True),
                     int(on.metrics.host_wakeups.value), int(on.metrics.host_page_ins.value))
    got, wakeups, page_ins = runs["torch"]
    assert got == want and wakeups >= 1
    assert page_ins > 0 if policy == "upload" else page_ins == 0
    if greedy:
        assert runs["jax"] == runs["torch"]


def test_pressure_spill_then_admit(models):
    """A pool too small for the offered load admits anyway (release_for
    hibernates the coldest slots instead of stalling): every stream equals
    the port's tier-off run and the reference's tier-on run, with the same
    tier counters, and the ledger drains."""
    prompts = _prompts(41, (40, 37, 40, 33))
    kw = dict(max_concurrency=3, prompt_buckets=(16, 64), admit_batch=1, max_queue=8)
    tier = dict(min_resident_slots=1, thrash_enter_events=10_000)
    off = _engine(models, "torch", **kw)
    want = {o.request_id: o.tokens for o in off.run(_requests("torch", prompts, n_new=12))}
    runs = {}
    for pkg in ("torch", "jax"):
        engine = _engine(models, pkg, tier=tier, num_blocks=10, **kw)
        for r in _requests(pkg, prompts, n_new=12):
            assert engine.submit(r).accepted
        outs = {}
        while engine.has_work:
            for o in engine.step():
                outs[o.request_id] = o.tokens
            _conservation(engine)
        assert engine.kv_tier.host_blocks == 0
        runs[pkg] = (outs, engine.kv_tier.memory_stats(), int(engine.metrics.host_hibernated.value))
    assert runs["torch"][0] == want == runs["jax"][0]
    assert runs["torch"][1:] == runs["jax"][1:] and runs["torch"][2] >= 1


def test_crash_exact_resume_mid_spill(models, tmp_path):
    """An engine with journaled progress is abandoned mid-spill (hibernated
    records and spilled trie blocks live only in host memory); a fresh
    tier-on engine resumes from the journal alone: nothing lost, every
    stream equal to the uninterrupted tier-off run."""
    prompts = _prompts(19, (6, 21, 40, 9))
    kw = dict(max_concurrency=4, prompt_buckets=(16, 64), admit_batch=4)
    off = _engine(models, "torch", prefix=True, num_blocks=48, **kw)
    want = {o.request_id: o.tokens for o in off.run(_requests("torch", prompts, n_new=12))}
    journal = str(tmp_path / "serve.journal")
    a = _engine(models, "torch", tier={}, prefix=True, num_blocks=48, journal=journal, **kw)
    for r in _requests("torch", prompts, n_new=12):
        assert a.submit(r).accepted

    def mid_decode():
        slots = [int(s) for s in np.flatnonzero(a._active)]
        return len(slots) == 4 and all(len(a._slot_out[s].tokens) >= 2 for s in slots)

    while not mid_decode():
        a.step()
    for s in [int(s) for s in np.flatnonzero(a._active)][:2]:
        assert a.kv_tier.hibernate_slot(s) > 0
    assert a.kv_tier.hibernated_count == 2
    a.kv_tier.page_out_trie(64)
    scan = RequestJournal.scan(journal)
    assert len(scan.submits) == 4 and not scan.finishes
    b = _engine(models, "torch", tier={}, prefix=True, num_blocks=48, journal=journal, **kw)
    report = b.resume(journal)
    outcomes = {rid: out.tokens for rid, out in report.completed.items()}
    while b.has_work:
        for o in b.step():
            outcomes[o.request_id] = o.tokens
    assert sorted(outcomes) == sorted(scan.submits)
    assert outcomes == want
    mem = b.memory_stats()
    assert mem["slots_active"] == 0 and mem["host_tier/hibernated"] == 0


@pytest.mark.parametrize("policy", ["upload", "prefill"])
def test_int8_pool_tier_on_equals_tier_off(models, policy):
    """An int8 pool: the spill and the upload carry the fp32 scale planes
    with the payload (the block bytes count them), and tier-on streams equal
    tier-off ones, greedy and sampled, through forced hibernation."""
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, kv_cache_dtype=torch.int8),
                       device="cpu")
    model.load_state_dict(models[2].state_dict())
    prompts = _prompts(43, (7, 19, 30))
    reqs = [Request(prompt=list(p), params=SamplingParams(
                max_new_tokens=12, temperature=0.8 if i % 2 else 0.0,
                top_k=7 if i % 2 else None, seed=i)) for i, p in enumerate(prompts)]
    kw = dict(device="cpu", max_concurrency=3, prompt_buckets=(16, 64), admit_batch=3,
              paged_kv=PagedKVConfig(block_tokens=BT), paged_attention="fused")
    want = {o.request_id: o.tokens for o in ServingEngine(model, **kw).run(reqs)}
    on = ServingEngine(model, kv_tier=KVTierConfig(wake_policy=policy), **kw)
    assert on._cache.quantized
    cfg = model.config
    assert on.kv_tier.block_bytes == cfg.n_layer * 2 * BT * cfg.n_head * (cfg.head_dim + 4)
    for r in [Request(prompt=r.prompt, params=r.params) for r in reqs]:
        assert on.submit(r).accepted
    assert _drain(on, {}, force_hibernate=True) == want
    assert (on.metrics.host_page_ins.value > 0) == (policy == "upload")


def test_release_device_frees_the_host_tier(models):
    """`_release_device` drops every host buffer: the spilled trie blocks and
    the hibernated records."""
    engine = _engine(models, "torch", tier={}, prefix=True, num_blocks=48, max_concurrency=4,
                     prompt_buckets=(16, 64), admit_batch=4)
    for r in _requests("torch", _prompts(19, (6, 21, 40, 9)), n_new=12):
        assert engine.submit(r).accepted
    for _ in range(3):
        engine.step()
    engine.kv_tier.hibernate_slot(int(np.flatnonzero(engine._active)[0]))
    assert engine.kv_tier.host_bytes > 0
    tier = engine.kv_tier
    engine._release_device()
    assert tier.host_bytes == 0 and tier.hibernated_count == 0 and tier.uploads_in_flight == 0
    assert isinstance(tier, KVTier)


@pytest.mark.parametrize("policy", ["upload", "prefill"])
def test_background_spill_and_idle_hibernation_equal_the_reference(models, policy):
    """The per-step poll's own work: a low-water mark pages trie blocks out
    in the background, and a zero idle bound hibernates every slot with a
    token at each poll (then one wakes). Streams equal tier-off, and the
    streams and tier counters equal the reference's."""
    prompts = _prompts(47, (20, 35, 18, 40, 33))
    prompts[2] = prompts[0][:16] + prompts[2][16:]  # a shared first block
    kw = dict(max_concurrency=3, prompt_buckets=(16, 64), admit_batch=2, pipeline_depth=1)
    off = _engine(models, "torch", prefix=True, **kw)
    want = {o.request_id: o.tokens for o in off.run(_requests("torch", prompts, n_new=8))}
    tier = dict(wake_policy=policy, low_water_blocks=20, hibernate_idle_s=0.0)
    runs = {}
    for pkg in ("torch", "jax"):
        engine = _engine(models, pkg, tier=tier, prefix=True, num_blocks=24, **kw)
        outs = {o.request_id: o.tokens for o in engine.run(_requests(pkg, prompts, n_new=8))}
        runs[pkg] = (outs, engine.kv_tier.memory_stats())
    assert runs["torch"][0] == want == runs["jax"][0]
    assert runs["torch"][1] == runs["jax"][1]
    assert runs["torch"][1]["page_outs"] > 0 and runs["torch"][1]["wakeups"] > 0


def test_thrash_freeze_marks_the_trace_and_thaws(models):
    """Two page events inside the window freeze spill: the count moves, an
    ``EV_ANOMALY`` enter marker is traced, spill and page-in stop (the
    tier-off behaviour); after a calm ``thrash_exit_s`` the poll thaws it
    with an exit marker, and the trace validates clean."""
    from accelerate_tpu_torch.serving import Tracer
    from accelerate_tpu_torch.serving.trace import EV_ANOMALY, validate

    tracer = Tracer()
    clock = [0.0]
    engine = _engine(models, "torch", tier=dict(thrash_enter_events=2, thrash_window_s=10.0,
                                                thrash_exit_s=5.0),
                     prefix=True, num_blocks=48, max_concurrency=2, prompt_buckets=(16, 64),
                     tracer=tracer)
    tier = engine.kv_tier
    tier.guard.clock = lambda: clock[0]
    engine.run(_requests("torch", _prompts(29, (40, 21))))
    assert tier.page_out_trie(5) == 2 and tier.guard.frozen
    assert tier.page_out_trie(5) == 0
    assert engine.metrics.host_thrash_events.value == 1
    spilled = next(iter(tier.trie_blocks._entries))
    assert tier.ensure_resident([spilled]) == []  # frozen: no page-in either
    clock[0] = 20.0
    tier.poll()  # calm starts
    clock[0] = 26.0
    tier.poll()  # calm for 6 s: thaws
    assert not tier.guard.frozen
    marks = [ev.data["phase"] for ev in tracer.events() if ev.kind == EV_ANOMALY]
    assert marks == ["enter", "exit"]
    assert validate(tracer.events())["clean"]
