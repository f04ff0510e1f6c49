"""The port's anomaly monitor and flight recorder (`serving.anomaly`)
against the reference's, on the CPU.

The same seeded series (a calm baseline, spikes, a sustained excursion,
a collapse, an oscillation around the threshold, EWMA smoothing and
downsampling) fed to both packages' `AnomalyMonitor` fire and clear the same
detectors at the same ticks, with the same scores, the same `EV_ANOMALY`
markers and the same gauges. Then the port on its own: hysteresis, the
frozen baseline, the floor, the rate-limited atomic bundles (their JSON
holding a real port engine's trace tail, metrics, `memory_stats`,
`capacity_headroom`, queue, journal frontier and step timings), a contained
write failure, and the engine's ``anomaly=`` hook (observed once a step; the
null monitor by default).
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from accelerate_tpu.serving import ServingMetrics as JaxServingMetrics  # noqa: E402
from accelerate_tpu.serving import Tracer as JaxTracer  # noqa: E402
from accelerate_tpu.serving import anomaly as jax_anomaly  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    NULL_ANOMALY,
    AnomalyConfig,
    AnomalyMonitor,
    Detector,
    Request,
    SamplingParams,
    ServingEngine,
    ServingMetrics,
    Tracer,
)
from accelerate_tpu_torch.serving.anomaly import BUNDLE_FORMAT, _atomic_write_json  # noqa: E402
from accelerate_tpu_torch.serving.trace import EV_ANOMALY, validate  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


class StubScheduler:
    queue_depth = 0

    def snapshot_queue(self):
        return []


class StubEngine:
    """The attribute surface `AnomalyMonitor.observe`/`_collect` reads."""

    def __init__(self, metrics, tracer=None):
        self.metrics = metrics
        self.scheduler = StubScheduler()
        self.tracer = tracer
        self.journal = None
        self._step_count = 0
        self.last_step_timings = {"total_s": 0.001}

    def memory_stats(self):
        return {"slots_total": 4, "slots_active": 1}

    def capacity_headroom(self):
        return {"admissible_requests": 3}


def _cfg(mod, **kw):
    base = dict(window=32, min_samples=4, zscore=6.0, enter_steps=2, exit_steps=3,
                exit_fraction=0.5)
    base.update(kw)
    return mod.AnomalyConfig(**base)


def _series(seed):
    """Named signals: a noisy baseline with a short spike (must not arm), a
    sustained excursion (arms, then clears), a collapse of a low-direction
    signal, and a value oscillating around the threshold."""
    r = np.random.default_rng(seed)
    base = 1.0 + 0.05 * r.standard_normal(200)
    itl = base.copy()
    itl[40] = 50.0  # one-sample spike
    itl[80:95] = 40.0 + r.standard_normal(15)  # sustained
    queue = np.abs(np.round(3 + 2 * r.standard_normal(200)))
    queue[120:140] = 60.0
    free = 100.0 + r.standard_normal(200)
    free[150:170] = 5.0  # collapse
    osc = base.copy()
    osc[60:120:2] = 1.0 + 6.5 * 0.05 * 1.4826  # hovering near the trigger
    return {"itl_p99_s": itl, "queue_depth": queue, "blocks_free": free,
            "ttft_p99_s": osc, "custom_signal": 2.0 + r.standard_normal(200) ** 2}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", [dict(), dict(ewma_alpha=0.5), dict(enter_steps=1, exit_steps=1),
                                 dict(zscore=3.0, window=16)],
                         ids=["default", "ewma", "fast", "tight"])
def test_same_series_same_edges_as_the_reference(seed, cfg):
    series = _series(seed)
    ticks = {}
    for pkg, mod, metrics, tracer_cls in (("port", __import__(
            "accelerate_tpu_torch.serving.anomaly", fromlist=["x"]), ServingMetrics, Tracer),
            ("ref", jax_anomaly, JaxServingMetrics, JaxTracer)):
        clk = FakeClock()
        tracer = tracer_cls(clock=clk)
        mon = mod.AnomalyMonitor(_cfg(mod, **cfg), clock=clk, wall_clock=clk)
        eng = StubEngine(metrics(), tracer)
        edges = []
        for i in range(200):
            clk.t += 1.0
            for name, values in series.items():
                info = mon.ingest(name, float(values[i]), eng)
                if info is not None:
                    edges.append((i, info))
        events = [(ev.ts, ev.data) for ev in tracer.events() if ev.kind == EV_ANOMALY]
        ticks[pkg] = (edges, events, mon.gauges(), mon.active, mon.events,
                      {n: (d.trips, d.active, d.last) for n, d in mon.detectors.items()})
    assert ticks["port"] == ticks["ref"]
    edges = ticks["port"][0]
    assert edges, "the series never fired"
    fired = {info["detector"] for _, info in edges if info["phase"] == "enter"}
    assert "queue_depth" in fired and "blocks_free" in fired
    assert not any(i == 40 and info["detector"] == "itl_p99_s" and info["phase"] == "enter"
                   for i, info in edges) or cfg.get("enter_steps") == 1


def test_detector_hysteresis_floor_and_frozen_baseline():
    cfg = _cfg(__import__("accelerate_tpu_torch.serving.anomaly", fromlist=["x"]))
    det = Detector("x", "high", cfg)
    for v in [1.0, 1.1, 0.9, 1.0, 1.05, 0.95]:
        assert det.update(v) is None
    assert det.update(50.0) is None  # one hot sample does not arm
    assert det.update(1.0) is None
    assert det.update(50.0) is None and det.update(50.0) == "enter"
    window = list(det.window)
    assert det.update(60.0) is None and list(det.window) == window  # frozen
    assert [det.update(1.0) for _ in range(3)] == [None, None, "exit"]
    low = Detector("free", "low", cfg)
    for v in [100.0, 101.0, 99.0, 100.0, 100.5]:
        low.update(v)
    assert [low.update(1.0), low.update(1.0)] == [None, "enter"]
    q = Detector("queue_depth", "high", cfg, floor=4.0)
    for v in [0.0, 0.0, 0.0, 0.0, 0.0]:
        q.update(v)
    assert [q.update(3.0) for _ in range(4)] == [None] * 4  # under the floor
    with pytest.raises(ValueError):
        Detector("bad", "sideways", cfg)


def _port_engine(tracer=None, anomaly=None, journal=None):
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    return ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(8,),
                         paged_kv=True, tracer=tracer, anomaly=anomaly, journal=journal)


def test_bundle_from_a_port_engine_is_valid_json(tmp_path):
    clk = FakeClock()
    mon = AnomalyMonitor(AnomalyConfig(window=32, min_samples=4, enter_steps=1, exit_steps=1,
                                       bundle_dir=str(tmp_path / "b"), bundle_min_interval_s=60.0),
                         clock=clk, wall_clock=clk)
    tracer = Tracer()
    engine = _port_engine(tracer=tracer, anomaly=mon, journal=str(tmp_path / "j.journal"))
    r = np.random.default_rng(0)
    for n in (5, 6, 7):
        engine.submit(Request(r.integers(0, 256, n).tolist(), SamplingParams(max_new_tokens=4)))
    engine.step()
    assert mon._tick == 1  # observed once a step
    for _ in range(6):
        mon.ingest("custom", 1.0, engine)
    enter = mon.ingest("custom", 500.0, engine)
    assert enter["phase"] == "enter" and os.path.exists(enter["bundle"])
    clk.t += 10.0
    assert mon.ingest("custom", 1.0, engine)["phase"] == "exit"
    assert mon.ingest("custom", 500.0, engine)["bundle"] is None  # rate-limited
    assert mon.bundles_written == 1 and len(list((tmp_path / "b").glob("*.json"))) == 1
    doc = json.loads(open(enter["bundle"]).read())
    assert doc["format"] == BUNDLE_FORMAT and doc["trigger"]["detector"] == "custom"
    assert doc["step"] == 1 and doc["active"] == ["custom"]
    assert doc["trace_tail"] and doc["trace_tail"][0][1] == "submit"
    assert doc["metrics"]["serving/steps"] == 1
    assert doc["memory_stats"]["block_pool/blocks_total"] == engine._allocator.num_blocks
    assert "token_capacity_remaining" in doc["capacity_headroom"]
    assert [q["rid"] for q in doc["queue"]] == [2]
    assert doc["journal"]["bytes_written"] > 0
    assert set(doc["step_timings"]) >= {"total_s", "dispatch_s"}
    while engine.has_work:
        engine.step()
    assert validate(tracer.events())["clean"]
    gauges = mon.gauges()
    assert gauges["anomaly/bundles"] == 1 and "custom" in mon.active
    assert gauges["anomaly/active"] == len(mon.active)
    assert gauges["anomaly/last_bundle"] == enter["bundle"]


def test_bundle_write_failure_is_contained(tmp_path, monkeypatch):
    import accelerate_tpu_torch.serving.anomaly as mod

    mon = AnomalyMonitor(AnomalyConfig(window=32, min_samples=4, enter_steps=1,
                                       bundle_dir=str(tmp_path)), clock=FakeClock())
    eng = StubEngine(ServingMetrics(), Tracer())

    def boom(path, doc):
        raise OSError("disk full")

    monkeypatch.setattr(mod, "_atomic_write_json", boom)
    for _ in range(5):
        mon.ingest("x", 1.0, eng)
    info = mon.ingest("x", 99.0, eng)
    assert info["phase"] == "enter" and info["bundle"] is None and mon.bundle_errors == 1
    with pytest.raises(TypeError):
        _atomic_write_json(tmp_path / "t.json", {"bad": object()})
    assert not list(tmp_path.glob("*.tmp"))


def test_engine_defaults_to_the_null_monitor_and_observe_every():
    engine = _port_engine()
    assert engine.anomaly is NULL_ANOMALY and not engine.anomaly.enabled
    assert NULL_ANOMALY.observe(engine) == [] and NULL_ANOMALY.gauges() == {}
    mon = AnomalyMonitor(AnomalyConfig(observe_every=3))
    eng = StubEngine(ServingMetrics())
    fed = []
    mon.ingest = lambda name, value, engine=None: fed.append(name)
    for _ in range(6):
        mon.observe(eng)
    assert len(fed) == 2 * 2  # queue_depth and goodput on ticks 3 and 6
