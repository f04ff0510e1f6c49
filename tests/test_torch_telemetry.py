"""The port's continuous telemetry (`serving.telemetry`) and the engine's
telemetry hooks, on the CPU, tiny GPT-2: the Prometheus text of a port
engine round-trips through the port's parser, the text renderer and parser
give the reference's bytes and values for the same gauges (histogram
families, replica labels, non-finite values), the JSONL series carries the
exact pool bytes, the /metrics endpoint serves on 127.0.0.1 only, the ring
is bounded and cadence-gated under an injected clock, ``tracker=`` with
``metrics_log_every`` logs the snapshot, and the metrics' histogram buckets,
summaries and snapshot keys of the port engine's new families are the
reference's after the same observations.
"""

import json
import math
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.serving import PrefixCacheConfig as JaxPrefixCacheConfig  # noqa: E402
from accelerate_tpu.serving import Request as JaxRequest  # noqa: E402
from accelerate_tpu.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from accelerate_tpu.serving import ServingEngine as JaxServingEngine  # noqa: E402
from accelerate_tpu.serving import ServingMetrics as JaxServingMetrics  # noqa: E402
from accelerate_tpu.serving import SLOSpec as JaxSLOSpec  # noqa: E402
from accelerate_tpu.serving import telemetry as jax_telemetry  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, params_from_jax  # noqa: E402
from accelerate_tpu_torch.models.kv_cache import tree_bytes_by_dtype, tree_nbytes  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    NULL_TELEMETRY,
    PagedKVConfig,
    PrefixCacheConfig,
    Request,
    SamplingParams,
    ServingEngine,
    ServingMetrics,
    SLOSpec,
    TelemetryConfig,
    TelemetryExporter,
)
from accelerate_tpu_torch.serving.telemetry import (  # noqa: E402
    parse_prometheus_text,
    prometheus_name,
    sanitize_scalars,
    to_prometheus_text,
)
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def models():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32))
    params = jmod.init_params(jax.random.key(0))
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmod, params, model


def _prompts(seed, lens):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, n).tolist() for n in lens]


def _stub_engine(snapshot=None):
    snapshot = snapshot if snapshot is not None else {"serving/x": 1.0}
    return SimpleNamespace(metrics=SimpleNamespace(steps=SimpleNamespace(value=7),
                                                   snapshot=lambda: dict(snapshot)))


def _all_ready(engine):
    """The reference engine sees every dispatch ready at its reap, as the
    port's CPU engine does (its own readiness follows XLA's CPU threads)."""
    def reap(finished):
        while engine._inflight:
            engine._process_oldest(finished)
    engine._reap_ready = reap


def _port_engine(model, **kw):
    return ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(8,),
                         prefix_cache=PrefixCacheConfig(block_tokens=8, num_blocks=4), **kw)


# ------------------------------------------------------------ byte accounting
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_pool_bytes_match_nbytes_across_dtypes(kind, paged):
    """The gauges are exact tensor byte sums, for fp32, bf16 and int8 KV
    (with its fp32 scale planes), in both modes."""
    kw = {"fp32": dict(dtype=torch.float32), "bf16": dict(dtype=torch.bfloat16),
          "int8": dict(dtype=torch.float32, kv_cache_dtype=torch.int8)}[kind]
    model = GPT2LMHead(GPT2Config.tiny(**kw), device="cpu")
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(8, 32),
                           paged_kv=PagedKVConfig(block_tokens=8) if paged else False,
                           prefix_cache=PrefixCacheConfig(block_tokens=8, num_blocks=4))
    mem = engine.memory_stats()
    tensors = engine._cache.k + engine._cache.v + [engine._cache.index] + (
        engine._cache.k_scale + engine._cache.v_scale if kind == "int8" else [])
    assert mem["slot_pool_bytes"] == tree_nbytes(engine._cache) == sum(
        t.numel() * t.element_size() for t in tensors)
    by_dtype = tree_bytes_by_dtype(engine._cache)
    assert sum(by_dtype.values()) == mem["slot_pool_bytes"]
    for dtype, n in by_dtype.items():
        assert mem[f"slot_pool_bytes/{dtype}"] == n
    assert {"int8": {"int8", "float32"}, "bf16": {"bfloat16"}}.get(kind, {"float32"}) <= set(
        by_dtype)
    if kind == "int8":
        assert mem["quant/kv_bits"] == 8
    if paged:
        assert mem["block_pool/pool_bytes"] == mem["slot_pool_bytes"]
        assert (mem["block_pool/blocks_free"] + mem["block_pool/blocks_resident"]
                + mem["block_pool/blocks_private"] == mem["block_pool/blocks_total"])
    else:
        assert mem["block_pool/pool_bytes"] == engine.prefix_cache.pool_nbytes == tree_nbytes(
            engine.prefix_cache.pool)


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_capacity_headroom_monotone_as_slots_fill(models, paged):
    _, _, model = models
    engine = ServingEngine(model, device="cpu", max_concurrency=4, prompt_buckets=(8,),
                           max_queue=8, paged_kv=paged)
    idle = engine.capacity_headroom()
    assert idle["admissible_requests"] == 4 and idle["est_slot_free_s"] == 0.0
    assert idle["seconds_to_exhaustion"] is None  # no rate yet, never inf
    assert idle["token_capacity_remaining"] == 4 * (engine.max_len - 1)
    seen = [idle]
    for i in range(4):
        assert engine.submit(Request([1 + i, 2, 3, 4], SamplingParams(max_new_tokens=40))).accepted
        engine.step()
        seen.append(engine.capacity_headroom())
    assert [h["slots_free"] for h in seen] == [4, 3, 2, 1, 0]
    for prev, cur in zip(seen, seen[1:]):
        assert cur["admissible_requests"] <= prev["admissible_requests"]
        assert cur["token_capacity_remaining"] <= prev["token_capacity_remaining"]
        if paged:
            assert cur["blocks_free"] <= prev["blocks_free"]
    assert seen[-1]["seconds_to_exhaustion"] is not None
    assert seen[-1]["est_slot_free_s"] is not None and seen[-1]["est_slot_free_s"] > 0


# ------------------------------------------------------------ export surfaces
def test_prometheus_round_trip_from_engine_run(models, tmp_path):
    _, _, model = models
    prom = tmp_path / "metrics.prom"
    telemetry = TelemetryExporter(TelemetryConfig(interval_s=0.0, prometheus_path=str(prom)))
    engine = _port_engine(model, telemetry=telemetry)
    for i, p in enumerate(_prompts(3, [6, 7, 6])):
        engine.submit(Request(p, SamplingParams(max_new_tokens=3),
                              slo=SLOSpec(ttft_s=1e9, name="chat") if i else None))
    while engine.has_work:
        engine.step()
    point = telemetry.sample(engine)
    text = prom.read_text()
    assert text == telemetry.prometheus_text()
    parsed = parse_prometheus_text(text)
    assert parse_prometheus_text(text) == jax_telemetry.parse_prometheus_text(text)
    for name, value in parsed.items():
        assert name.startswith("accelerate_tpu_")
        base, _, label = name.partition("{")
        assert all(c.isalnum() or c == "_" for c in base)
        if label:
            assert base.endswith("_bucket") and 'le="' in label
        assert math.isfinite(value)
    # every finite numeric gauge of the point is in the text, at its value
    for key, value in point.items():
        if key.startswith("_") or isinstance(value, str) or value is None:
            continue
        if "/bucket/" in key or key.endswith("/sum") or (
                key.endswith("/count") and f"{key[:-6]}/sum" in point):
            continue  # the histogram families: _bucket/_sum/_count series
        assert parsed[prometheus_name(key)] == float(value), key
    assert parsed[prometheus_name("serving/mem/slot_pool_bytes")] == tree_nbytes(engine._cache)
    assert parsed[prometheus_name("serving/slo/chat/attainment")] == 1.0
    ttft = prometheus_name("serving/ttft_s")
    assert parsed[f"{ttft}_count"] == parsed[f'{ttft}_bucket{{le="+Inf"}}'] == 3
    telemetry.close()


def test_prometheus_text_is_the_reference_text():
    """The same gauges render to the same bytes in both packages: plain
    gauges, a histogram family (cumulative buckets, +Inf, sum, count),
    replica labels, bools, strings and non-finite values dropped."""
    m, ref = ServingMetrics(), JaxServingMetrics()
    for metrics in (m, ref):
        for v in (0.0003, 0.002, 0.002, 0.04, 7.0, 1e6):
            metrics.ttft_s.observe(v)
        metrics.queue_depth.observe(3)
        metrics.record_compile("admit[pb8b2]", 1.25)
    snap = m.snapshot()
    ref_snap = ref.snapshot()
    for key in ("serving/ttft_s", "serving/queue_depth", "serving/compile_s"):
        fam = {k: v for k, v in snap.items() if k.startswith(key + "/")}
        assert fam == {k: v for k, v in ref_snap.items() if k.startswith(key + "/")}, key
    assert snap["serving/compile/admit[pb8b2]"] == ref_snap["serving/compile/admit[pb8b2]"]
    values = {k: v for k, v in snap.items() if k.startswith(("serving/ttft_s", "serving/queue"))}
    values.update({"replica0/serving/steps": 3, "replica1/serving/steps": 5, "serving/steps": 8,
                   "serving/flag": True, "serving/name": "x", "serving/bad": float("nan"),
                   "serving/worse": float("-inf")})
    text = to_prometheus_text(values)
    assert text == jax_telemetry.to_prometheus_text(values)
    parsed = parse_prometheus_text(text)
    assert parsed['accelerate_tpu_serving_steps{replica="1"}'] == 5
    assert prometheus_name("serving/bad") not in parsed
    assert parsed[prometheus_name("serving/flag")] == 1


def test_jsonl_time_series_byte_gauges_exact(models, tmp_path):
    _, _, model = models
    path = tmp_path / "telemetry.jsonl"
    telemetry = TelemetryExporter(TelemetryConfig(interval_s=0.0, jsonl_path=str(path)))
    engine = _port_engine(model, telemetry=telemetry)
    for p in _prompts(5, [6, 7]):
        engine.submit(Request(p, SamplingParams(max_new_tokens=3)))
    steps = 0
    while engine.has_work:
        engine.step()
        steps += 1
    telemetry.close()
    raw = path.read_text()
    assert "NaN" not in raw and "Infinity" not in raw
    lines = [json.loads(line) for line in raw.splitlines()]
    assert len(lines) == len(telemetry.points()) == steps  # polled once a step
    assert [p["_step"] for p in lines] == list(range(1, steps + 1))
    for point in lines:
        assert point["serving/mem/slot_pool_bytes"] == tree_nbytes(engine._cache)
        assert point["serving/mem/block_pool/pool_bytes"] == tree_nbytes(engine.prefix_cache.pool)
        assert "serving/headroom/token_capacity_remaining" in point
    assert engine.metrics.step_phase_telemetry_s.sum > 0


def test_http_metrics_endpoint_on_loopback_only():
    telemetry = TelemetryExporter(TelemetryConfig(interval_s=0.0))
    telemetry.sample(_stub_engine({"serving/x": 2.5, "serving/y": 3}))
    with pytest.raises(ValueError, match="127.0.0.1"):
        telemetry.serve_http(0, host="0.0.0.0")
    port = telemetry.serve_http(0)
    assert telemetry._server.server_address[0] == "127.0.0.1"
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    assert parse_prometheus_text(body) == parse_prometheus_text(telemetry.prometheus_text())
    assert parse_prometheus_text(body)[prometheus_name("serving/x")] == 2.5
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/other", timeout=10)
    telemetry.close()
    assert telemetry.http_port is None


def test_non_finite_gauges_never_escape():
    nan, inf = float("nan"), float("inf")
    assert sanitize_scalars({"a": nan, "b": inf, "c": 1.5, "d": "s"}) == {
        "a": None, "b": None, "c": 1.5, "d": "s"}
    text = to_prometheus_text({"serving/bad": nan, "serving/worse": -inf, "serving/good": 2.0})
    assert list(parse_prometheus_text(text)) == [prometheus_name("serving/good")]
    telemetry = TelemetryExporter(TelemetryConfig(interval_s=0.0))
    point = telemetry.sample(_stub_engine({"serving/bad": inf}))
    assert point["serving/bad"] is None and "Infinity" not in json.dumps(point)


def test_ring_bounded_and_cadence_gated():
    t = [0.0]
    telemetry = TelemetryExporter(TelemetryConfig(interval_s=1.0, capacity=4), clock=lambda: t[0])
    stub = _stub_engine()
    assert telemetry.poll(stub) is not None
    assert telemetry.poll(stub) is None
    t[0] = 0.5
    assert telemetry.poll(stub) is None
    t[0] = 1.0
    assert telemetry.poll(stub) is not None
    for _ in range(10):
        telemetry.sample(stub)
    assert len(telemetry.points()) == 4 and telemetry.dropped == 8
    assert telemetry.latest()["_step"] == 7


def test_null_telemetry_default_is_inert(models):
    _, _, model = models
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(8,))
    assert engine.telemetry is NULL_TELEMETRY and not engine.telemetry.enabled
    assert NULL_TELEMETRY.poll(engine) is None and NULL_TELEMETRY.sample(engine) is None
    NULL_TELEMETRY.close()
    point = TelemetryExporter(TelemetryConfig(interval_s=0.0)).sample(
        SimpleNamespace(metrics=ServingMetrics()))
    assert point["serving/requests_submitted"] == 0
    assert not any(k.startswith("serving/mem/") for k in point)


def test_tracker_logs_every_n_steps(models):
    """``tracker=`` with ``metrics_log_every=N`` hands the snapshot to the
    tracker every N steps (the reference's `log_to`)."""
    _, _, model = models
    logged = []
    tracker = SimpleNamespace(log=lambda values, step=None: logged.append((step, values)))
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(8,),
                           tracker=tracker, metrics_log_every=2)
    engine.run([Request(p, SamplingParams(max_new_tokens=5)) for p in _prompts(2, [5, 6, 7])])
    steps = engine.metrics.steps.value
    assert [s for s, _ in logged] == list(range(2, steps + 1, 2))
    assert all("serving/steps" in values for _, values in logged)


def test_telemetry_points_carry_the_reference_keys(models):
    """A sampled point of the port engine and of the reference engine, after
    the same greedy run: every ``serving/mem/`` and ``serving/headroom/``
    key, the goodput keys, the SLO class keys and the supervisor keys of the
    reference are in the port's point (the reference's extra families are its
    KV tier, cluster and front door, which the port has not yet). The
    reference engine sees every dispatch ready at its reap, so both take the
    same steps."""
    jmod, params, model = models
    prompts = _prompts(9, [5, 6, 7])
    points = []
    for eng, req, sp, slo in (
            (ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(8,),
                           prefix_cache=PrefixCacheConfig(block_tokens=8, num_blocks=4)),
             Request, SamplingParams, SLOSpec),
            (JaxServingEngine(jmod, params, max_concurrency=2, prompt_buckets=(8,),
                              prefix_cache=JaxPrefixCacheConfig(block_tokens=8, num_blocks=4)),
             JaxRequest, JaxSamplingParams, JaxSLOSpec)):
        if isinstance(eng, JaxServingEngine):
            _all_ready(eng)
        eng.run([req(p, sp(max_new_tokens=4), slo=slo(ttft_s=1e9, name="c")) for p in prompts])
        points.append(TelemetryExporter(TelemetryConfig(interval_s=0.0)).sample(eng))
    got, want = points
    families = ("serving/mem/", "serving/headroom/", "serving/slo", "serving/goodput",
                "supervisor/", "serving/step_total_s/", "serving/request_latency_s/",
                "serving/queue_depth/", "serving/slot_occupancy/")
    keys = {k for k in want if k.startswith(families) and "/bucket/" not in k}
    assert keys - set(got) == set()
    for key in keys:
        if key.startswith(("serving/mem/slot_pool_bytes", "serving/mem/block_pool/pool_bytes",
                           "serving/headroom/decode_tokens_per_sec",
                           "serving/headroom/seconds_to_exhaustion", "serving/goodput_tokens_per",
                           "serving/step_total_s/", "serving/request_latency_s/",
                           "serving/mem/inflight")) or key.endswith(("/sum", "/mean", "/min",
                                                                      "/max", "/p50", "/p90",
                                                                      "/p99")):
            continue  # wall-clock rates and timings, and the layouts' byte sums
        assert got[key] == want[key], key
