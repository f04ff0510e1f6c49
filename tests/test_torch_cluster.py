"""The port's multi-replica serving (`serving.cluster`) against the reference's
`ServingCluster`, on the CPU, tiny GPT-2 in fp32 (parameters carried across
by `params_from_jax`).

Both clusters front two (three for the double kill) supervised replicas of
their package's engine, slot mode with the prefix cache, on the same greedy
traffic: a first wave seeds the replicas' tries, a second shares their
prefixes. Under ``prefix`` and ``round_robin`` placement the cluster ids,
the replica each request lands on, the streams (token for token; each
reference stream's top-2 margin asserted), `router_stats` and the heartbeat
must be the reference's; so must a replica kill and a double kill at the
same step (outputs, ``migrations``, ``migrated_requests``, the final
placements). The reference engines see every dispatch ready at their reap,
as the port's CPU engine does, so both fleets step alike and load ties
break alike.

Port against port: greedy and sampled streams from the cluster, under both
policies, through a kill and in paged mode, equal one lone engine's; a
retired replica gives back its device buffers and its graph. The host-side
cases mirror the reference's tests: config checks, role gating, brownout
routing, resumed requests in their own admission run, the telemetry
namespace, and `aggregate_snapshots` against the reference's on the same
snapshots (exact).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.serving import ClusterConfig as JaxClusterConfig  # noqa: E402
from accelerate_tpu.serving import PrefixCacheConfig as JaxPrefixCacheConfig  # noqa: E402
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import ServingCluster as JaxServingCluster  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JaxServingEngine  # noqa: E402
from accelerate_tpu.serving import SupervisorConfig as JaxSupervisorConfig  # noqa: E402
from accelerate_tpu.serving.metrics import ServingMetrics as JaxServingMetrics  # noqa: E402
from accelerate_tpu.serving.metrics import aggregate_snapshots as jax_aggregate  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    FINISH_LENGTH,
    REJECT_UNHEALTHY,
    ClusterConfig,
    FIFOScheduler,
    PrefixCacheConfig,
    Request,
    SamplingParams,
    ServingCluster,
    ServingEngine,
    ServingMetrics,
    SupervisorConfig,
    TelemetryConfig,
    TelemetryExporter,
    Tracer,
    aggregate_snapshots,
)
from accelerate_tpu_torch.serving.cluster import (  # noqa: E402
    POLICY_ROUND_ROBIN,
    ROLE_DECODE,
    ROLE_PREFILL,
    STATE_DEAD,
    STATE_RETIRED,
)
from accelerate_tpu_torch.serving.telemetry import (  # noqa: E402
    parse_prometheus_text,
    to_prometheus_text,
)
from accelerate_tpu_torch.serving.trace import EV_MIGRATE, EV_ROUTE  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BUCKETS = (16, 32)
# a reference step whose top-2 gap is below this could flip on fp32
# summation-order differences: a near-tie, not a port fault
MIN_MARGIN = 1e-3

PKG = {
    "jax": dict(Request=JaxRequest, SamplingParams=JaxSamplingParams, Cluster=JaxServingCluster,
                ClusterConfig=JaxClusterConfig, SupervisorConfig=JaxSupervisorConfig,
                PrefixCacheConfig=JaxPrefixCacheConfig),
    "torch": dict(Request=Request, SamplingParams=SamplingParams, Cluster=ServingCluster,
                  ClusterConfig=ClusterConfig, SupervisorConfig=SupervisorConfig,
                  PrefixCacheConfig=PrefixCacheConfig),
}


@pytest.fixture(scope="module")
def models():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jmod.init_params(jax.random.key(0))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmod, params, model


def _all_ready(engine):
    """The reference engine sees every dispatch ready at its reap, as the
    port's CPU engine does (its fetches land at dispatch)."""
    def reap(finished):
        while engine._inflight:
            engine._process_oldest(finished)
    engine._reap_ready = reap


def _factory(pkg, models, **fixed):
    jmod, params, model = models
    if pkg == "jax":
        def build(**kw):
            engine = JaxServingEngine(jmod, params, max_concurrency=2, prompt_buckets=BUCKETS,
                                      max_queue=32, **fixed, **kw)
            _all_ready(engine)
            return engine
        return build
    return lambda **kw: ServingEngine(model, device="cpu", max_concurrency=2,
                                      prompt_buckets=BUCKETS, max_queue=32, **fixed, **kw)


def _waves(seed=0):
    """Two waves of prompts: the first seeds the tries with two 16-token
    prefixes, the second shares them (and adds one that shares nothing).
    Seed 0 keeps every greedy stream clear of near-ties (the margin assert
    refuses a seed that does not)."""
    r = np.random.default_rng(seed)
    a, b = (r.integers(0, 256, 16).tolist() for _ in range(2))
    tail = lambda n: r.integers(0, 256, n).tolist()  # noqa: E731
    first = [a + tail(3), b + tail(5), a + tail(2), b + tail(4)]
    second = [b + tail(6), a + tail(1), tail(9), a + tail(7), b + tail(2), a + tail(4)]
    return first, second


def _requests(pkg, prompts, n_new, sampled=False):
    p = PKG[pkg]
    return [p["Request"](list(x), p["SamplingParams"](
                max_new_tokens=n_new, temperature=0.9 if sampled and i % 2 else 0.0,
                top_k=5 if sampled and i % 2 else None, seed=100 + i))
            for i, x in enumerate(prompts)]


def _kill(replica):
    """Break a replica's engine in place: its next step raises a recoverable
    error; with ``max_restarts=0`` its supervisor fails unhealthy at once."""
    def boom():
        raise RuntimeError("injected device loss")
    replica.engine.step = boom


def _drive(cluster, outs, steps=None):
    n = 0
    while cluster.has_work and (steps is None or n < steps):
        for o in cluster.step():
            assert o.request_id not in outs, "delivered twice"
            outs[o.request_id] = (o.tokens, o.finish_reason)
        n += 1
    return outs


def _serve(pkg, models, tmp_path, policy, *, replicas=2, kills=(), sampled=False, **fixed):
    """Both waves through one cluster. ``kills`` is ((step of wave 2,
    replica), ...): the replica is killed before that step; a replica index
    ``-1`` kills wherever request 0 of wave 2 lives then. Returns the run's
    record."""
    p = PKG[pkg]
    fixed.setdefault("prefix_cache", p["PrefixCacheConfig"]())
    cluster = p["Cluster"](_factory(pkg, models, **fixed), tmp_path / f"{pkg}-{policy}",
                           replicas=replicas, config=p["ClusterConfig"](policy=policy),
                           supervisor_config=p["SupervisorConfig"](max_restarts=0))
    first, second = _waves()
    outs, placed = {}, []
    for r in _requests(pkg, first, 6, sampled):
        rid = cluster.submit(r).request_id
        placed.append((rid, cluster.placement(rid)[0]))
    _drive(cluster, outs)
    wave2 = []
    for r in _requests(pkg, second, 10, sampled):
        rid = cluster.submit(r).request_id
        wave2.append(rid)
        placed.append((rid, cluster.placement(rid)[0]))
    kills = dict(kills)
    step = 0
    while cluster.has_work:
        if step in kills:
            victim = kills[step]
            _kill(cluster.replicas[cluster.placement(wave2[0])[0] if victim < 0 else victim])
        _drive(cluster, outs, steps=1)
        step += 1
    cluster.close()
    return dict(cluster=cluster, outs=outs, placed=placed,
                final=[cluster.placement(rid)[0] for rid in sorted(outs)],
                stats=cluster.router_stats(),
                heartbeat={k: v for k, v in cluster.heartbeat().items() if k != "replicas"},
                prompts=first + second)


def _assert_clear_of_ties(models, run):
    """Each reference greedy stream's every step has a top-2 logit gap above
    MIN_MARGIN (one batched causal forward over prompt + stream)."""
    jmod, params, _ = models
    rows = [p + run["outs"][rid][0][:-1] for rid, p in enumerate(run["prompts"])]
    width = max(map(len, rows))
    ids = np.zeros((len(rows), width), np.int32)
    for i, row in enumerate(rows):
        ids[i, :len(row)] = row
    logits = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids)))
    for i, p in enumerate(run["prompts"]):
        top2 = np.sort(logits[i, len(p) - 1:len(rows[i])], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MIN_MARGIN, f"near-tie in reference stream {i}"


@pytest.fixture(scope="module")
def lone(models):
    """One lone port engine's streams of both waves, greedy and sampled."""
    out = {}
    for sampled in (False, True):
        first, second = _waves()
        engine = ServingEngine(models[2], device="cpu", max_concurrency=2, prompt_buckets=BUCKETS)
        streams = [o.tokens for o in engine.run(_requests("torch", first, 6, sampled))]
        streams += [o.tokens for o in engine.run(_requests("torch", second, 10, sampled))]
        out[sampled] = streams
    return out


@pytest.mark.parametrize("policy", ["prefix", "round_robin"])
def test_placements_ids_streams_and_stats_equal_the_reference(models, tmp_path, policy):
    """Tolerance: none. Cluster ids, placements, greedy fp32 streams,
    router stats and the heartbeat counts are the reference cluster's."""
    ref = _serve("jax", models, tmp_path, policy)
    got = _serve("torch", models, tmp_path, policy)
    _assert_clear_of_ties(models, ref)
    assert got["placed"] == ref["placed"]
    assert [rid for rid, _ in got["placed"]] == list(range(10))
    assert got["outs"] == ref["outs"]
    assert all(reason == FINISH_LENGTH for _, reason in got["outs"].values())
    assert got["stats"] == ref["stats"]
    assert got["heartbeat"] == ref["heartbeat"]
    if policy == "prefix":
        # the second wave followed the tries: both replicas served, and the
        # router matched cached tokens
        assert got["stats"]["cluster/route_match_tokens"] > 0
        assert {rep for _, rep in got["placed"][4:]} == {0, 1}
    else:
        assert [rep for _, rep in got["placed"]] == [0, 1] * 5


@pytest.mark.parametrize("case", ["kill", "double_kill"])
def test_migration_equals_the_reference(models, tmp_path, case):
    """A replica killed mid-decode (and, with three replicas, the replica
    request 0 migrated to killed one step later): the same outputs token for
    token, ``migrations``, ``migrated_requests`` and final placements as the
    reference cluster; no request lost, none delivered twice."""
    kw = (dict(kills=((2, 0),)) if case == "kill"
          else dict(replicas=3, kills=((2, -1), (4, -1))))
    ref = _serve("jax", models, tmp_path, POLICY_ROUND_ROBIN, **kw)
    got = _serve("torch", models, tmp_path, POLICY_ROUND_ROBIN, **kw)
    assert sorted(got["outs"]) == list(range(10))
    assert got["outs"] == ref["outs"]
    assert got["final"] == ref["final"]
    assert got["stats"] == ref["stats"]
    kills = 1 if case == "kill" else 2
    assert got["stats"]["cluster/migrations"] == kills
    assert got["stats"]["cluster/migrated_requests"] >= kills
    assert got["heartbeat"]["unhealthy"] == kills


@pytest.mark.parametrize("case", ["prefix", "round_robin", "kill", "paged"])
def test_sampled_streams_equal_a_lone_engine(models, tmp_path, lone, case):
    """Port against port, tolerance none: greedy and seeded sampled streams
    from the cluster equal one lone engine's, whichever replica served them,
    through a kill's migration and in paged mode."""
    kw = dict(kills=((2, 0),)) if case == "kill" else {}
    if case == "paged":
        kw["paged_kv"] = True
    policy = "prefix" if case in ("prefix", "paged") else POLICY_ROUND_ROBIN
    got = _serve("torch", models, tmp_path, policy, sampled=True, **kw)
    assert [got["outs"][rid][0] for rid in range(10)] == lone[True]


def test_migration_journals_the_resumed_prefix_and_traces_the_move(models, tmp_path):
    """The migrated stream's prefix is journaled on its new replica (so a
    second kill finds it there), and the tracers carry EV_ROUTE and
    EV_MIGRATE."""
    tracers = [Tracer(), Tracer()]
    cluster = ServingCluster(_factory("torch", models), tmp_path, replicas=2,
                             config=ClusterConfig(policy=POLICY_ROUND_ROBIN), tracers=tracers,
                             supervisor_config=SupervisorConfig(max_restarts=0))
    first, _ = _waves()
    rids = [cluster.submit(r).request_id for r in _requests("torch", first, 12)]
    outs = _drive(cluster, {}, steps=3)
    _kill(cluster.replicas[0])
    _drive(cluster, outs)
    assert sorted(outs) == rids
    assert cluster.replicas[0].state == STATE_DEAD
    routes = [e for e in tracers[0].events() + tracers[1].events() if e.kind == EV_ROUTE]
    assert len(routes) == len(rids) + cluster.migrated_requests
    moves = [e for e in tracers[1].events() if e.kind == EV_MIGRATE]
    assert len(moves) == cluster.migrated_requests >= 1
    assert all(e.data["from_replica"] == 0 and e.data["to_replica"] == 1 for e in moves)
    from accelerate_tpu_torch.serving import RequestJournal
    scan = RequestJournal.scan(cluster.replicas[1].journal_path)
    resumed = [e.data["resumed"] for e in moves]
    assert any(resumed)
    for e, k in zip(moves, resumed):
        assert len(scan.finishes[e.rid][1]) == 12 and k < 12


def test_retired_replica_releases_its_device_memory(models, tmp_path):
    """Retiring gives back the engine's KV pool, slot buffers and pinned
    rings (a DEAD replica's too, when it is replaced); the handle and its
    index stay."""
    cluster = ServingCluster(_factory("torch", models, paged_kv=True), tmp_path, replicas=3,
                             config=ClusterConfig(policy=POLICY_ROUND_ROBIN),
                             supervisor_config=SupervisorConfig(max_restarts=0))
    first, _ = _waves()
    rids = [cluster.submit(r).request_id for r in _requests("torch", first, 4)]
    outs = _drive(cluster, {}, steps=1)
    cluster.retire_replica(0)
    _kill(cluster.replicas[1])
    _drive(cluster, outs)
    assert sorted(outs) == rids
    successor = cluster.replace_replica(1)
    assert successor.index == 3 and cluster.replaced_replicas == 1
    for i in (0, 1):
        engine = cluster.replicas[i].engine
        assert cluster.replicas[i].state == STATE_RETIRED
        assert engine._cache is None and engine._d_tokens is None and engine._graph is None
        assert engine._fetch_ring == []
    assert [r.index for r in cluster.replicas] == [0, 1, 2, 3]
    assert cluster.live_replicas == 2
    cluster.close()


# --- host-side cases, mirrored from the reference's tests -------------------------
def test_cluster_config_validation(models, tmp_path):
    with pytest.raises(ValueError, match="policy"):
        ClusterConfig(policy="fastest")
    with pytest.raises(ValueError, match="roles"):
        ClusterConfig(roles=("mixed", "bogus"))
    with pytest.raises(ValueError, match="replicas"):
        ServingCluster(_factory("torch", models), tmp_path, replicas=0)
    with pytest.raises(ValueError, match="roles"):
        ServingCluster(_factory("torch", models), tmp_path, replicas=2,
                       config=ClusterConfig(roles=("mixed",)))


def test_role_gating_prefers_capable_replicas(models, tmp_path):
    cluster = ServingCluster(_factory("torch", models), tmp_path, replicas=2,
                             config=ClusterConfig(policy=POLICY_ROUND_ROBIN,
                                                  roles=(ROLE_DECODE, ROLE_PREFILL)))
    rids = [cluster.submit(Request(list(range(1, 5)), SamplingParams(max_new_tokens=2)))
            .request_id for _ in range(3)]
    assert [cluster.placement(r)[0] for r in rids] == [1, 1, 1]
    _drive(cluster, {})
    cluster.close()


def test_brownout_replica_routed_around(models, tmp_path):
    cluster = ServingCluster(_factory("torch", models), tmp_path, replicas=2,
                             config=ClusterConfig(policy=POLICY_ROUND_ROBIN),
                             supervisor_config=SupervisorConfig(brownout_ttft_s=0.01),
                             headroom_fns=[lambda: {"est_slot_free_s": 99.0},
                                           lambda: {"est_slot_free_s": 0.0}])
    rid0 = cluster.submit(Request(list(range(1, 5)), SamplingParams(max_new_tokens=4))).request_id
    assert cluster.placement(rid0)[0] == 0
    cluster.step()
    assert cluster.replicas[0].supervisor.brownout_level >= 1
    rid1 = cluster.submit(Request(list(range(1, 6)), SamplingParams(max_new_tokens=2))).request_id
    assert cluster.placement(rid1)[0] == 1
    outs = _drive(cluster, {})
    assert outs[rid0][1] == outs[rid1][1] == FINISH_LENGTH
    cluster.close()


def test_migration_disabled_fails_loud_and_dead_cluster_rejects(models, tmp_path):
    cluster = ServingCluster(_factory("torch", models), tmp_path, replicas=2,
                             config=ClusterConfig(policy=POLICY_ROUND_ROBIN, migrate=False),
                             supervisor_config=SupervisorConfig(max_restarts=0))
    rids = [cluster.submit(Request(p, SamplingParams(max_new_tokens=8))).request_id
            for p in _waves()[0][:2]]
    outs = _drive(cluster, {}, steps=1)
    _kill(cluster.replicas[0])
    _drive(cluster, outs)
    assert outs[rids[0]][1] == f"rejected:{REJECT_UNHEALTHY}"
    assert outs[rids[1]][1] == FINISH_LENGTH
    assert cluster.migrations == 0
    _kill(cluster.replicas[1])
    cluster.submit(Request([1, 2, 3], SamplingParams(max_new_tokens=8)))
    _drive(cluster, {})
    res = cluster.submit(Request([1, 2, 3], SamplingParams(max_new_tokens=2)))
    assert not res.accepted and res.reason == REJECT_UNHEALTHY
    cluster.close()


def test_resumed_requests_never_join_cached_runs():
    sched = FIFOScheduler(prompt_buckets=BUCKETS, max_queue=16)
    sched.prefill_len_fn = lambda req: req.prefill_len
    seen = []

    def cap(reqs):
        seen.append([r.request_id for r in reqs])
        return len(reqs)

    sched.capacity_fn = cap
    reqs = [Request(list(range(1, 9)), SamplingParams(max_new_tokens=4)) for _ in range(4)]
    reqs[2].resume_tokens = [7, 8, 9]
    for i, r in enumerate(reqs):
        r.request_id = i
        assert sched.submit(r).accepted
    assert sched.peek_run(8) == 2 and seen[-1] == [0, 1]
    assert [r.request_id for r in sched.pop_run(2)] == [0, 1]
    assert sched.peek_run(8) == 1 and seen[-1] == [2]
    assert [r.request_id for r in sched.pop_run(1)] == [2]
    assert sched.peek_run(8) == 1 and seen[-1] == [3]
    sched.capacity_fn = lambda rs: 0
    assert sched.peek_run(8) == 0


def test_cluster_telemetry_replica_namespace(models, tmp_path):
    cluster = ServingCluster(_factory("torch", models), tmp_path / "c", replicas=2)
    cluster.submit(Request([1, 2, 3], SamplingParams(max_new_tokens=2)))
    _drive(cluster, {})
    jsonl = tmp_path / "telemetry.jsonl"
    exporter = TelemetryExporter(TelemetryConfig(interval_s=0.0, jsonl_path=jsonl))
    point = exporter.sample(cluster)
    exporter.close()
    cluster.close()
    assert point["cluster/replicas"] == 2
    assert point["serving/requests_finished"] == 1
    assert "replica0/serving/steps" in point and "replica1/serving/steps" in point
    assert point["replica0/cluster/role"] == "mixed"
    assert jsonl.read_text().count("\n") == 1
    text = to_prometheus_text({k: v for k, v in point.items() if not k.startswith("_")})
    assert text.count("# TYPE accelerate_tpu_serving_steps gauge") == 1
    parsed = parse_prometheus_text(text)
    assert (parsed['accelerate_tpu_serving_steps{replica="0"}']
            == float(point["replica0/serving/steps"]))


def _filled_metrics(cls, seed):
    """One `ServingMetrics` of ``cls`` with counters, histograms, SLO
    classes, compiles and class sheds set from ``seed``."""
    from accelerate_tpu_torch.serving import SLOSpec
    r = np.random.default_rng(seed)
    m = cls()
    m.requests_submitted.inc(int(r.integers(1, 50)))
    m.tokens_generated.inc(int(r.integers(1, 500)))
    m.spec_forwards.inc(int(r.integers(0, 5)))
    m.spec_tokens.inc(int(r.integers(0, 20)))
    m.streams_opened.inc(int(r.integers(0, 9)))
    for v in r.exponential(0.05, int(r.integers(1, 40))):
        m.ttft_s.observe(float(v))
    for v in r.exponential(0.01, int(r.integers(0, 30))):
        m.stream_lag_s.observe(float(v))
    for name in ("a", "b")[:int(r.integers(1, 3))]:
        for ok in r.integers(0, 2, int(r.integers(1, 6))):
            m.observe_slo(SLOSpec(ttft_s=1.0, name=name), clean=True, ttft_ok=bool(ok),
                          itl_ok=True, tokens=int(r.integers(1, 9)))
    m.record_compile(f"admit[pb16b{int(r.integers(1, 3))}]", float(r.random()))
    for p in r.integers(0, 3, int(r.integers(0, 4))):
        m.observe_shed(int(p))
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_snapshots_equals_the_reference(seed):
    """The same replica snapshots (the reference's own `ServingMetrics`,
    filled alike) aggregate to the same dict, exactly, except the wall-clock
    rates; the port's own snapshots aggregate to the reference's on every
    key both packages export."""
    ref_snaps = [_filled_metrics(JaxServingMetrics, seed + k).snapshot() for k in range(3)]
    rate_keys = ("serving/tokens_per_sec", "serving/goodput_tokens_per_sec")
    for snap in ref_snaps:
        for key in rate_keys:
            snap[key] = 1.5
    assert aggregate_snapshots(ref_snaps) == jax_aggregate(ref_snaps)
    port_snaps = [_filled_metrics(ServingMetrics, seed + k).snapshot() for k in range(3)]
    for snap in port_snaps:
        for key in rate_keys:
            snap[key] = 1.5
    got, want = aggregate_snapshots(port_snaps), jax_aggregate(ref_snaps)
    shared = set(got) & set(want)
    assert {k for k in want if k.startswith(("serving/class/", "serving/slo/",
                                             "serving/stream_lag_s/"))} <= shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
