"""The port's elastic fleet (`serving.autoscaler`, `serving.kv_tier`
``ThrashGuard``) against the reference's, on the CPU.

The control loop is held to the reference's, tolerance none: both
`FleetAutoscaler`s drive their own copy of one host-only stub fleet under a
scripted clock, scripted headroom (load, idle, dead and draining replicas)
and scripted spawn failures, and must make the same scale events (spawns,
retires, forced retires, replacements) in the same order, with the same
gauges and the same EV_ANOMALY ``autoscale_thrash`` pairs after every
evaluation; `ThrashGuard` must freeze and thaw as the reference's on the same
event times. The reference's own control cases are mirrored.

On port engines (tiny GPT-2, fp32): a spawn that fails at the
``cluster.replica_spawn`` fault point retries and leaves no directory
behind; a drained replica retires with no request lost, its index kept and
its telemetry stopped; a forced retire migrates its backlog; a dead replica
is replaced; and a surge then idle under `FleetAutoscaler(min_replicas=1,
max_replicas=3)`, with spawns under traffic, delivers a lone engine's streams
token for token.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from accelerate_tpu.serving import AutoscalerConfig as JaxAutoscalerConfig  # noqa: E402
from accelerate_tpu.serving import FleetAutoscaler as JaxFleetAutoscaler  # noqa: E402
from accelerate_tpu.serving.kv_tier import ThrashGuard as JaxThrashGuard  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead  # noqa: E402
from accelerate_tpu_torch.reliability import FaultInjector, FaultSpec, inject  # noqa: E402
from accelerate_tpu_torch.reliability import faults  # noqa: E402
from accelerate_tpu_torch.serving import (  # noqa: E402
    DETECTOR_THRASH,
    FINISH_LENGTH,
    AutoscalerConfig,
    ClusterConfig,
    FleetAutoscaler,
    Request,
    SamplingParams,
    ServingCluster,
    ServingEngine,
    SupervisorConfig,
    TelemetryConfig,
    TelemetryExporter,
    ThrashGuard,
    Tracer,
)
from accelerate_tpu_torch.serving.cluster import POLICY_ROUND_ROBIN, STATE_RETIRED  # noqa: E402
from accelerate_tpu_torch.serving.trace import EV_ANOMALY  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

PKG = {"jax": (JaxFleetAutoscaler, JaxAutoscalerConfig),
       "torch": (FleetAutoscaler, AutoscalerConfig)}


# --- the stub fleet: the surface FleetAutoscaler reads and drives -----------------
class _StubEngine:
    def __init__(self):
        self.max_concurrency = 2
        self.active_slots = 0
        self.last_step_timings = {"total_s": 0.001}
        self.scheduler = SimpleNamespace(queue_depth=0)
        self.tracer = None


class _StubReplica:
    def __init__(self, index):
        self.index = index
        self.role = "mixed"
        self.retired = False
        self.draining = False
        self.migrated = False
        self.engine = _StubEngine()
        self.supervisor = SimpleNamespace(unhealthy=False)

    @property
    def accepting(self):
        return not self.retired and not self.draining and not self.supervisor.unhealthy


class _StubCluster:
    def __init__(self, n=1):
        self.replicas = [_StubReplica(i) for i in range(n)]
        self.autoscaler = None
        self.replaced_replicas = 0
        self.queue_depth = 0
        self.est_slot_free_s = None
        self.spawn_script = []  # an exception (or None) per add_replica call
        self.events = []
        self.force_outputs = []

    def _accepting(self):
        return [r for r in self.replicas if r.accepting]

    def capacity_headroom(self):
        acc = self._accepting()
        total = sum(r.engine.max_concurrency for r in acc)
        head = {"queue_depth": self.queue_depth,
                "slots_free": total - sum(r.engine.active_slots for r in acc),
                "slots_total": total}
        if self.est_slot_free_s is not None:
            head["est_slot_free_s"] = self.est_slot_free_s
        return head

    def add_replica(self, role="mixed"):
        if self.spawn_script:
            exc = self.spawn_script.pop(0)
            if exc is not None:
                raise exc
        rep = _StubReplica(len(self.replicas))
        self.replicas.append(rep)
        self.events.append(("add", rep.index))
        return rep

    def retire_replica(self, index, *, force=False):
        rep = self.replicas[index]
        if force:
            rep.draining, rep.retired = False, True
            self.events.append(("force", index))
            return list(self.force_outputs)
        rep.draining = True
        self.events.append(("retire", index))
        return []

    def replace_replica(self, index):
        successor = self.add_replica()
        self.replicas[index].retired = True
        self.replaced_replicas += 1
        self.events.append(("replace", index))
        return successor


class _StubTracer:
    enabled = True

    def __init__(self):
        self.events = []

    def emit(self, kind, rid, **fields):
        self.events.append((kind, fields))


def _load(cluster, queue=4, w0=1.0):
    cluster.queue_depth = queue
    cluster.est_slot_free_s = w0
    for r in cluster._accepting():
        r.engine.active_slots = r.engine.max_concurrency


def _idle(cluster):
    cluster.queue_depth = 0
    cluster.est_slot_free_s = None
    for r in cluster._accepting():
        r.engine.active_slots = 0


def _scaler(pkg, cluster, clk, tracer=None, **cfg):
    cls, config = PKG[pkg]
    cfg.setdefault("target_ttft_s", 0.5)
    cfg.setdefault("thrash_enter_events", 99)
    return cls(cluster, config(**cfg), clock=lambda: clk[0], sleep=lambda s: None, tracer=tracer)


def _script(seed):
    """A seeded control script: the config and, per evaluation, the clock
    step and what happens to the fleet before it."""
    r = np.random.default_rng(seed)
    cfg = dict(min_replicas=int(r.integers(1, 3)), scale_up_windows=int(r.integers(1, 4)),
               scale_down_idle_windows=int(r.integers(1, 4)),
               dwell_s=float(r.choice([0.0, 2.0])), eval_interval_s=float(r.choice([0.0, 0.5])),
               drain_grace_evals=int(r.integers(1, 4)), thrash_enter_events=int(r.integers(2, 6)),
               thrash_window_s=20.0, thrash_exit_s=5.0)
    cfg["max_replicas"] = cfg["min_replicas"] + int(r.integers(1, 4))
    steps = []
    for _ in range(60):
        x = r.random()
        event = ("load" if x < 0.4 else "idle" if x < 0.75 else "kill" if x < 0.82
                 else "drain" if x < 0.88 else "flaky" if x < 0.94 else "busy_one")
        steps.append((float(r.choice([0.3, 1.0, 3.0])), event, int(r.integers(0, 8))))
    return cfg, steps


def _run_script(pkg, seed):
    cfg, steps = _script(seed)
    cluster, clk, tracer = _StubCluster(cfg["min_replicas"]), [0.0], _StubTracer()
    cluster.force_outputs = ["forced"]
    scaler = _scaler(pkg, cluster, clk, tracer=tracer, **cfg)
    trail = []
    for dt, event, k in steps:
        clk[0] += dt
        live = [r for r in cluster.replicas if not r.retired]
        if event == "load":
            _load(cluster, queue=k, w0=float(k))
        elif event == "idle":
            _idle(cluster)
        elif event == "kill" and live:
            live[k % len(live)].supervisor.unhealthy = True
        elif event == "drain" and live:
            live[k % len(live)].draining = True
        elif event == "flaky":
            cluster.spawn_script = [OSError("flaky")] * (k % 4)
        elif event == "busy_one" and live:
            live[k % len(live)].engine.active_slots = 1
        outs = scaler.evaluate()
        trail.append((list(cluster.events), outs, scaler.gauges(), scaler.frozen,
                      scaler.evaluations))
    anomalies = [(f["phase"], f.get("window_events")) for kind, f in tracer.events
                 if kind == "anomaly" and f["detector"] == "autoscale_thrash"]
    return trail, anomalies


@pytest.mark.parametrize("seed", range(8))
def test_scale_events_and_gauges_equal_the_reference(seed):
    """Tolerance: none. A seeded script of load, idle, kills, drains and
    flaky spawns under a scripted clock: the same scale events in the same
    order, forced-retire outputs, gauges, freeze state and thrash anomaly
    pairs after every evaluation."""
    got, got_anomalies = _run_script("torch", seed)
    want, want_anomalies = _run_script("jax", seed)
    assert got == want
    assert got_anomalies == want_anomalies
    assert got[-1][0], "the script made no scale event"


def test_thrash_guard_equals_the_reference():
    """Tolerance: none. The same event times and polls freeze and thaw both
    guards at the same calls, with the same window counts."""
    r = np.random.default_rng(0)
    for _ in range(5):
        clk = [0.0]
        args = (float(r.choice([2.0, 5.0])), int(r.integers(2, 6)), 0.25, float(r.choice([1.0, 3.0])))
        guards = [ThrashGuard(*args, clock=lambda: clk[0]),
                  JaxThrashGuard(*args, clock=lambda: clk[0])]
        for _ in range(200):
            clk[0] += float(r.exponential(0.4))
            if r.random() < 0.5:
                n = int(r.integers(1, 3))
                assert len({g.record(n) for g in guards}) == 1
            else:
                assert len({g.poll() for g in guards}) == 1
            assert len({(g.frozen, g.window_events) for g in guards}) == 1


# --- mirrored control cases ----------------------------------------------------------
def test_config_validation():
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(scale_up_windows=0), dict(idle_slots_fraction=0.0)):
        with pytest.raises(ValueError):
            AutoscalerConfig(**bad)


def test_scale_up_needs_consecutive_breach_windows():
    cluster, clk = _StubCluster(1), [0.0]
    scaler = _scaler("torch", cluster, clk, scale_up_windows=3, max_replicas=3)
    _load(cluster)
    scaler.evaluate()
    scaler.evaluate()
    assert cluster.events == []
    scaler.evaluate()
    assert cluster.events == [("add", 1)] and scaler.target_replicas == 2
    assert scaler.gauges()["autoscaler/actual_replicas"] == 2


def test_one_slow_evaluation_never_spawns():
    cluster, clk = _StubCluster(1), [0.0]
    scaler = _scaler("torch", cluster, clk, scale_up_windows=2, max_replicas=3)
    for _ in range(3):
        _load(cluster)
        scaler.evaluate()
        _idle(cluster)
        scaler.evaluate()
    assert cluster.events == []
    _load(cluster)
    scaler.evaluate()
    scaler.evaluate()
    assert cluster.events == [("add", 1)]


def test_scale_down_retires_least_loaded_newest_first_never_below_min():
    cluster, clk = _StubCluster(3), [0.0]
    scaler = _scaler("torch", cluster, clk, scale_down_idle_windows=2)
    _idle(cluster)
    cluster.replicas[0].engine.active_slots = 1
    scaler.evaluate()
    scaler.evaluate()
    assert cluster.events == [("retire", 2)] and scaler.target_replicas == 2
    lone, clk1 = _StubCluster(1), [0.0]
    scaler1 = _scaler("torch", lone, clk1, scale_down_idle_windows=1)
    _idle(lone)
    for _ in range(5):
        scaler1.evaluate()
    assert lone.events == [] and scaler1.retires == 0


def test_dwell_and_eval_interval():
    cluster, clk = _StubCluster(1), [0.0]
    scaler = _scaler("torch", cluster, clk, scale_up_windows=1, dwell_s=10.0, max_replicas=4)
    _load(cluster)
    scaler.evaluate()
    for t in range(1, 10):
        clk[0] = float(t)
        _load(cluster)
        scaler.evaluate()
    assert len(cluster.events) == 1
    clk[0] = 10.5
    _load(cluster)
    scaler.evaluate()
    assert len(cluster.events) == 2
    clk2 = [0.0]
    gated = _scaler("torch", _StubCluster(1), clk2, eval_interval_s=1.0)
    gated.evaluate()
    clk2[0] = 0.5
    gated.evaluate()
    assert gated.evaluations == 1
    clk2[0] = 1.1
    gated.evaluate()
    assert gated.evaluations == 2


def test_thrash_guard_freezes_then_unfreezes_with_anomaly_pair():
    cluster, clk, tracer = _StubCluster(1), [0.0], Tracer()
    scaler = FleetAutoscaler(cluster, AutoscalerConfig(
        target_ttft_s=0.5, scale_up_windows=1, max_replicas=8, thrash_window_s=60.0,
        thrash_enter_events=2, thrash_exit_fraction=0.25, thrash_exit_s=5.0),
        clock=lambda: clk[0], sleep=lambda s: None, tracer=tracer)
    for t in (0.0, 0.1, 0.2):
        clk[0] = t
        _load(cluster)
        scaler.evaluate()
    assert scaler.frozen and len(cluster.events) == 2
    assert scaler.gauges()["autoscaler/scale_frozen"] == 1
    _idle(cluster)
    clk[0] = 61.0
    scaler.evaluate()
    assert scaler.frozen
    clk[0] = 67.0
    scaler.evaluate()
    assert not scaler.frozen
    phases = [e.data["phase"] for e in tracer.events()
              if e.kind == EV_ANOMALY and e.data["detector"] == DETECTOR_THRASH]
    assert phases == ["enter", "exit"]


def test_spawn_retries_then_degrades_gracefully():
    cluster, clk = _StubCluster(1), [0.0]
    scaler = _scaler("torch", cluster, clk, scale_up_windows=1, max_replicas=3)
    cluster.spawn_script = [OSError("flaky"), OSError("flaky"), None]
    _load(cluster)
    scaler.evaluate()
    assert scaler.scale_ups == 1 and scaler.spawn_retries == 2 and scaler.spawn_failures == 0
    down, clk2 = _StubCluster(1), [0.0]
    scaler2 = _scaler("torch", down, clk2, scale_up_windows=1, max_replicas=3)
    down.spawn_script = [OSError("down")] * 3
    _load(down)
    scaler2.evaluate()
    assert scaler2.spawn_failures == 1 and scaler2.target_replicas == 1
    _load(down)
    scaler2.evaluate()
    assert down.events == [("add", 1)] and scaler2.target_replicas == 2


def test_dead_replaced_dead_draining_not_and_drain_grace_forces():
    cluster, clk = _StubCluster(2), [0.0]
    scaler = _scaler("torch", cluster, clk, drain_grace_evals=2, scale_down_idle_windows=99)
    cluster.replicas[0].supervisor.unhealthy = True
    cluster.replicas[1].draining = True
    cluster.force_outputs = ["sentinel"]
    _idle(cluster)
    assert scaler.evaluate() == []
    assert cluster.events == [("add", 2), ("replace", 0)]
    assert scaler.gauges()["autoscaler/replaced"] == 1 and scaler.scale_ups == 0
    assert scaler.evaluate() == []
    assert scaler.evaluate() == ["sentinel"]
    # the forced retire opens a gap below the target, which a spawn fills
    assert cluster.events[2:] == [("force", 1), ("add", 3)]
    assert set(scaler.gauges()) == set(FleetAutoscaler.GAUGES)


# --- on port engines --------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    return GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu", seed=0)


def _factory(model):
    return lambda **kw: ServingEngine(model, device="cpu", max_concurrency=2,
                                      prompt_buckets=(16, 32), max_queue=32, **kw)


def _requests(n, n_tokens=4, seed=11):
    r = np.random.default_rng(seed)
    return [Request(r.integers(0, 256, 4 + i).tolist(),
                    SamplingParams(max_new_tokens=n_tokens, seed=i,
                                   temperature=0.9 if i % 2 else 0.0))
            for i in range(n)]


def _lone(model, reqs):
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(16, 32))
    return [o.tokens for o in engine.run([Request(list(r.prompt), r.params) for r in reqs])]


def _drive(cluster, outs, max_steps=500):
    for _ in range(max_steps):
        if not cluster.has_work:
            break
        for o in cluster.step():
            assert o.request_id not in outs, "delivered twice"
            outs[o.request_id] = o
    return outs


def test_spawn_fault_point_retries_and_leaves_no_debris(model, tmp_path):
    cluster = ServingCluster(_factory(model), tmp_path / "c", replicas=1)
    scaler = FleetAutoscaler(cluster, AutoscalerConfig(max_replicas=4), sleep=lambda s: None)
    inj = FaultInjector(seed=0, specs=[FaultSpec.io_error(faults.SCOPE_REPLICA_SPAWN,
                                                          at_calls=(0, 1))])
    with inject(inj):
        assert scaler._spawn_one()
    assert scaler.spawn_retries == 2 and scaler.spawn_failures == 0
    assert cluster.replicas[1].index == 1
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == ["replica0", "replica1"]
    cluster.close()


def test_drain_retire_loses_nothing_keeps_indices_and_stops_telemetry(model, tmp_path):
    cluster = ServingCluster(_factory(model), tmp_path / "c", replicas=2,
                             config=ClusterConfig(policy=POLICY_ROUND_ROBIN))
    reqs = _requests(4)
    rids = [cluster.submit(r).request_id for r in reqs]
    outs = {o.request_id: o for o in cluster.step()}
    cluster.retire_replica(0)
    rep0 = cluster.replicas[0]
    assert rep0.draining and not rep0.accepting and not rep0.retired
    _drive(cluster, outs)
    assert rep0.retired and rep0.state == STATE_RETIRED
    assert [outs[rid].tokens for rid in rids] == _lone(model, reqs)
    assert [r.index for r in cluster.replicas] == [0, 1] and cluster.live_replicas == 1
    exporter = TelemetryExporter(TelemetryConfig(interval_s=0.0))
    point = exporter.sample(cluster)
    exporter.close()
    assert any(k.startswith("replica1/") for k in point)
    assert not any(k.startswith("replica0/") for k in point)
    cluster.close()


def test_forced_retire_migrates_the_backlog(model, tmp_path):
    cluster = ServingCluster(_factory(model), tmp_path / "c", replicas=2,
                             config=ClusterConfig(policy=POLICY_ROUND_ROBIN))
    reqs = _requests(6, n_tokens=8)
    rids = [cluster.submit(r).request_id for r in reqs]
    outs = {o.request_id: o for o in cluster.step()}
    outs.update({o.request_id: o for o in cluster.retire_replica(0, force=True)})
    assert cluster.replicas[0].retired and cluster.replicas[0].migrated
    _drive(cluster, outs)
    assert [outs[rid].tokens for rid in rids] == _lone(model, reqs)
    assert cluster.migrated_requests >= 1
    cluster.close()


def test_autoscaler_replaces_a_dead_replica(model, tmp_path):
    cluster = ServingCluster(_factory(model), tmp_path / "c", replicas=2,
                             config=ClusterConfig(policy=POLICY_ROUND_ROBIN),
                             supervisor_config=SupervisorConfig(max_restarts=0))
    FleetAutoscaler(cluster, AutoscalerConfig(max_replicas=4, thrash_enter_events=99))
    reqs = _requests(4, n_tokens=8)
    rids = [cluster.submit(r).request_id for r in reqs]
    outs = {o.request_id: o for o in cluster.step()}

    def boom():
        raise RuntimeError("injected engine death")

    cluster.replicas[0].engine.step = boom
    _drive(cluster, outs)
    assert cluster.replicas[0].retired and cluster.replaced_replicas == 1
    assert cluster.n_replicas == 3 and cluster.replicas[2].index == 2
    assert [outs[rid].tokens for rid in rids] == _lone(model, reqs)
    cluster.close()


def test_surge_then_idle_spawns_under_traffic_and_retires(model, tmp_path):
    """A surge against one replica makes the autoscaler spawn (while the
    first replica has work in flight), then idle drains the fleet back to
    ``min_replicas``: every stream equals a lone engine's, no request is
    lost, the scale events are traced, and each retired replica gave back
    its device buffers."""
    cluster = ServingCluster(_factory(model), tmp_path / "c", replicas=1)
    clk = [0.0]
    scaler = FleetAutoscaler(cluster, AutoscalerConfig(
        min_replicas=1, max_replicas=3, target_ttft_s=1e-9, scale_up_windows=1,
        thrash_enter_events=99), clock=lambda: clk[0], sleep=lambda s: None)
    reqs = _requests(10, n_tokens=6)
    rids = [cluster.submit(r).request_id for r in reqs[:4]]
    outs, busy_at_spawn = {}, []
    for i in range(300):
        clk[0] += 0.01
        before = cluster.n_replicas
        _drive(cluster, outs, max_steps=1)
        if cluster.n_replicas > before:  # the spawn ran at the end of this step
            busy_at_spawn.append(cluster.replicas[0].engine.active_slots)
        if i == 3:  # the second wave lands on the grown fleet
            rids += [cluster.submit(r).request_id for r in reqs[4:]]
        if i > 3 and not cluster.has_work:
            break
    assert cluster.n_replicas == 3 and busy_at_spawn and min(busy_at_spawn) > 0
    assert {1, 2} <= {cluster.placement(rid)[0] for rid in rids[4:]}  # the spawned replicas serve
    # idle: the fleet drains back to min_replicas, newest first
    scaler.config = AutoscalerConfig(min_replicas=1, max_replicas=3, target_ttft_s=1e9,
                                     scale_down_idle_windows=2, thrash_enter_events=99)
    for _ in range(12):
        clk[0] += 0.01
        cluster.step()
    assert sorted(outs) == sorted(rids)
    assert [outs[rid].tokens for rid in rids] == _lone(model, reqs)
    assert all(o.finish_reason == FINISH_LENGTH for o in outs.values())
    assert [r.state for r in cluster.replicas] == ["ok", STATE_RETIRED, STATE_RETIRED]
    assert scaler.scale_ups == 2 and scaler.retires == 2
    for rep in cluster.replicas[1:]:
        assert rep.engine._cache is None and rep.engine._graph is None
    cluster.close()
