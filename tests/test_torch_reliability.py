"""The port's reliability layer (`accelerate_tpu_torch.reliability`) against
the reference's, on the CPU.

The same `FaultInjector(seed, specs)` fires at the same calls and slots in
both packages (scheduled and probabilistic specs, every fault point),
`RetryPolicy` gives the same delays and the reference's retry semantics, and
SIGTERM sent to this test's own process through a `ServingPreemptionHandler`
drains a port engine and then snapshots what is left, which a fresh engine
resumes. SIGTERM sent to a training child through the training handler
lands a complete checkpoint this process loads, and checkpoint writes and
reads meet the same seeded faults as the reference's and retry past them.
"""

import os
import signal
import time
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from accelerate_tpu.reliability import faults as jax_faults  # noqa: E402
from accelerate_tpu.reliability import retry as jax_retry  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator as PortAccelerator  # noqa: E402
from accelerate_tpu_torch.accelerator import (  # noqa: E402
    ProjectConfiguration as PortProjectConfiguration,
)
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead  # noqa: E402
from accelerate_tpu_torch.reliability import faults as _port_faults  # noqa: E402
from accelerate_tpu_torch.reliability.preemption import SIGTERM_EXIT_CODE  # noqa: E402
from accelerate_tpu_torch.reliability import (  # noqa: E402
    ALL_SLOTS,
    SCOPE_SERVING_DECODE,
    SCOPE_SERVING_DISPATCH,
    DeviceLostError,
    FaultInjector,
    FaultSpec,
    PreemptionHandler,
    RetryError,
    RetryPolicy,
    ServingPreemptionHandler,
    TransientIOError,
    active_injector,
    fault_point,
    inject,
    install_serving_preemption_handler,
)
from accelerate_tpu_torch.serving import (  # noqa: E402
    SNAPSHOT_FORMAT,
    Request,
    SamplingParams,
    ServingEngine,
)
from torch_threads import one_torch_thread  # noqa: E402,F401


def _specs(pkg):
    """One spec of every kind, scheduled and probabilistic, in ``pkg``'s
    `FaultSpec`."""
    F = pkg.FaultSpec
    return [
        F.io_error("checkpoint.save", at_calls=(1, 4), probability=0.3, max_faults=3),
        F.poison(at_steps=(2,), slots=(1, 3)),
        F.poison(probability=0.25, slots=(0,)),
        F.poison(at_steps=(7,)),  # every active slot
        F.step_hang(at_calls=(3,), hang_s=0.5),
        F.device_error(probability=0.15, max_faults=2),
        F.preempt(probability=0.2),
    ]


def _drive(pkg, seed):
    """Every fault point 30 times through ``pkg``'s injector: what each call
    did, and the injector's log. SIGTERM is not sent: ``maybe_preempt`` runs
    with ``os.kill`` replaced by a recorder."""
    inj = pkg.FaultInjector(seed=seed, specs=_specs(pkg))
    did, kills, slept = [], [], []
    real_kill = pkg.os.kill
    pkg.os.kill = lambda pid, sig: kills.append(sig)
    try:
        for _ in range(30):
            try:
                inj.maybe_raise("checkpoint.save")
                did.append("ok")
            except pkg.TransientIOError:
                did.append("io")
            did.append(inj.poison_slots())
            try:
                did.append(inj.dispatch_faults(sleep=slept.append))
            except pkg.DeviceLostError:
                did.append("lost")
            did.append(inj.maybe_preempt())
    finally:
        pkg.os.kill = real_kill
    fired = [(e.scope, e.call_index, e.kind, tuple(e.slots)) for e in inj.fired]
    calls = {s: inj.calls(s) for s in ("checkpoint.save", SCOPE_SERVING_DECODE,
                                       SCOPE_SERVING_DISPATCH, "preemption")}
    return did, fired, kills, slept, calls


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_injector_fires_at_the_same_calls_and_slots_in_both_packages(seed):
    import accelerate_tpu_torch.reliability.faults as port_faults

    port = _drive(port_faults, seed)
    ref = _drive(jax_faults, seed)
    assert port == ref
    did, fired, kills, slept, _ = port
    kinds = {kind for _, _, kind, _ in fired}
    assert kinds == {"io_error", "poison_nan", "step_hang", "device_error", "preempt"}
    assert ALL_SLOTS in did and (1, 3) in did[:12]  # step 2 poisons slots 1 and 3
    assert slept == [0.5] and kills == [signal.SIGTERM]  # a preempt spec fires once


def test_scope_and_sentinel_semantics():
    inj = FaultInjector(specs=[FaultSpec.io_error("a", at_calls=(1,)),
                               FaultSpec.poison(at_steps=(0,), slots=(1, 3)),
                               FaultSpec.poison(at_steps=(2,))])
    inj.maybe_raise("a")
    inj.maybe_raise("b")  # another scope never fires
    with pytest.raises(TransientIOError):
        inj.maybe_raise("a")
    assert [(e.scope, e.call_index) for e in inj.fired] == [("a", 1)]
    assert inj.calls("a") == 2 and inj.calls("b") == 1
    assert inj.poison_slots() == (1, 3)
    assert inj.poison_slots() is None
    assert inj.poison_slots() == ALL_SLOTS == ()
    assert issubclass(TransientIOError, OSError) and issubclass(DeviceLostError, RuntimeError)


def test_inject_is_lexical_and_nests():
    a, b = FaultInjector(seed=1), FaultInjector(seed=2,
                                                specs=[FaultSpec.io_error("x", at_calls=(0,))])
    assert active_injector() is None
    fault_point("x")  # inactive: a no-op
    with inject(a):
        assert active_injector() is a
        with inject(b):
            with pytest.raises(TransientIOError):
                fault_point("x")
        assert active_injector() is a
    assert active_injector() is None


@pytest.mark.parametrize("seed", [0, 7, 8])
@pytest.mark.parametrize("jitter", [0.0, 0.1, 0.5])
def test_retry_delays_equal_the_reference(seed, jitter):
    kw = dict(max_attempts=7, base_delay_s=0.05, max_delay_s=0.5, jitter=jitter, seed=seed)
    port = list(RetryPolicy(**kw).delays())
    assert port == list(jax_retry.RetryPolicy(**kw).delays())
    assert port == list(RetryPolicy(**kw).delays())  # seeded per call


def test_retry_semantics():
    calls, sleeps = [], []
    policy = RetryPolicy(max_attempts=4, base_delay_s=0.1, multiplier=2.0, jitter=0.0)

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert policy.call(flaky, sleep=sleeps.append) == "ok"
    assert len(calls) == 3 and sleeps == [0.1, 0.2]
    with pytest.raises(RetryError) as info:
        RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0).call(
            lambda: (_ for _ in ()).throw(OSError("always")), sleep=lambda _: None)
    assert len(info.value.attempts) == 3 and isinstance(info.value.__cause__, OSError)
    calls.clear()

    def missing():
        calls.append(1)
        raise FileNotFoundError("no such file")

    with pytest.raises(FileNotFoundError):  # an OSError, but non_retryable wins
        RetryPolicy(max_attempts=5, base_delay_s=0.0).call(missing, sleep=lambda _: None)
    assert len(calls) == 1
    t = [0.0]
    with pytest.raises(RetryError, match="deadline") as info:
        RetryPolicy(max_attempts=10, base_delay_s=1.0, max_delay_s=2.0, jitter=0.0,
                    deadline_s=2.5).call(lambda: (_ for _ in ()).throw(OSError("down")),
                                         sleep=lambda d: t.__setitem__(0, t[0] + d),
                                         clock=lambda: t[0])
    assert len(info.value.attempts) == 2
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)


TRAINING_CHILD = """
import os, sys, time, torch
from accelerate_tpu_torch.accelerator import Accelerator, ProjectConfiguration
from accelerate_tpu_torch.reliability import install_preemption_handler
torch.set_num_threads(1)
torch.manual_seed(0)
acc = Accelerator(device="cpu", project_config=ProjectConfiguration(
    project_dir=sys.argv[1], automatic_checkpoint_naming=True))
model = acc.prepare(torch.nn.Linear(4, 2))
opt = acc.prepare(torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
step = acc.make_train_step(lambda m, b: (m(b["x"]) - b["y"]).pow(2).mean())
install_preemption_handler(acc)
g = torch.Generator().manual_seed(1)
for i in range(3):
    step({"x": torch.randn(8, 4, generator=g), "y": torch.randn(8, 2, generator=g)})
torch.save({"model": model.state_dict(), "updates": opt.num_updates},
           os.path.join(sys.argv[1], "trained.pt"))
print("ready", flush=True)
while True:  # training would go on here; SIGTERM lands the checkpoint and exits
    time.sleep(0.01)
"""


def test_sigterm_checkpoints_a_training_child_and_the_checkpoint_loads(tmp_path):
    """A child process trains through `make_train_step` with
    `install_preemption_handler(accelerator)`; SIGTERM makes it write a
    synchronous, complete ``save_state`` and exit 143, and a fresh
    accelerator here loads that checkpoint to the child's weights and
    update count."""
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    child = subprocess.Popen([sys.executable, "-c", TRAINING_CHILD, str(tmp_path)], cwd=root,
                             stdout=subprocess.PIPE, text=True,
                             env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        assert child.stdout.readline().strip() == "ready"
        child.send_signal(signal.SIGTERM)
        assert child.wait(timeout=60) == SIGTERM_EXIT_CODE
    finally:
        if child.poll() is None:
            child.kill()
    ckpt = tmp_path / "checkpoints" / "checkpoint_0"
    assert (ckpt / "_COMPLETE").exists()
    want = torch.load(tmp_path / "trained.pt")
    acc = PortAccelerator(device="cpu", project_config=PortProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True))
    torch.manual_seed(1)
    model = acc.prepare(torch.nn.Linear(4, 2))
    opt = acc.prepare(torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    assert acc.load_state() == str(ckpt)
    for name, value in model.state_dict().items():
        assert torch.equal(value, want["model"][name]), name
    assert opt.num_updates == want["updates"] == 3
    assert all("momentum_buffer" in s for s in opt.optimizer.state.values())


@pytest.mark.parametrize("seed", [0, 3])
def test_checkpoint_retries_meet_the_same_faults_as_the_reference(tmp_path, seed):
    """One seeded `FaultInjector` spec set, probabilistic at both
    checkpoint scopes, run through a save and a load of each package: the
    same calls fire (each file is one retried write or read with a fault
    point inside each attempt, in the reference's file order), every retry
    lands, and both checkpoints load back to the trained weights."""
    import optax

    from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
    from accelerate_tpu.data_loader import DataLoaderShard as JaxDataLoaderShard
    from accelerate_tpu.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.data_loader import DataLoaderShard

    def specs(pkg):
        return [pkg.FaultSpec.io_error("checkpoint.save", probability=0.4, max_faults=3),
                pkg.FaultSpec.io_error("checkpoint.restore", probability=0.4, max_faults=3)]

    batches = [{"x": np.full((4, 1), i, np.float32), "y": np.full((4, 1), 2.0 * i + 1, np.float32)}
               for i in range(3)]
    AcceleratorState._reset_state()
    GradientState._reset_state()
    jacc = JaxAccelerator()
    jmodel, _, _ = jacc.prepare(
        (lambda p, x: p["a"] * x + p["b"], {"a": np.zeros(1, np.float32), "b": np.zeros(1, np.float32)}),
        optax.sgd(0.1), JaxDataLoaderShard(batches))
    jinj = jax_faults.FaultInjector(seed=seed, specs=specs(jax_faults))
    with jax_faults.inject(jinj):
        jdir = jacc.save_state(str(tmp_path / "ref"))
        jacc.load_state(jdir)

    pacc = PortAccelerator(device="cpu")
    pmodel = pacc.prepare(torch.nn.Linear(1, 1))
    pacc.prepare(torch.optim.SGD(pmodel.parameters(), lr=0.1), DataLoaderShard(batches))
    step = pacc.make_train_step(lambda m, b: (m(b["x"]) - b["y"]).pow(2).mean())
    step({k: torch.as_tensor(v) for k, v in batches[0].items()})
    trained = {k: v.clone() for k, v in pmodel.state_dict().items()}
    pinj = FaultInjector(seed=seed, specs=specs(_port_faults))
    with inject(pinj):
        pdir = pacc.save_state(str(tmp_path / "port"))
        with torch.no_grad():
            for p in pmodel.parameters():
                p.zero_()
        pacc.load_state(pdir)

    fired = [(e.scope, e.call_index) for e in pinj.fired]
    assert fired == [(e.scope, e.call_index) for e in jinj.fired]
    assert pinj._calls == jinj._calls
    # both scopes fired and were retried past: more attempts than the 6 files
    assert {s for s, _ in fired} == {"checkpoint.save", "checkpoint.restore"}
    assert pinj._calls["checkpoint.save"] > 6 and pinj._calls["checkpoint.restore"] > 6
    assert (Path(pdir) / "_COMPLETE").exists() and (Path(jdir) / "_COMPLETE").exists()
    for k, v in pmodel.state_dict().items():
        assert torch.equal(v, trained[k])
    np.testing.assert_array_equal(np.asarray(jmodel.params["a"]), np.zeros(1, np.float32))


def test_second_sigterm_does_not_reenter_the_handler():
    """A SIGTERM landing while the handler's work is in flight is counted
    and swallowed: the work runs once."""
    calls = {"n": 0}

    class Handler(PreemptionHandler):
        def _on_preempt(self):
            calls["n"] += 1
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.monotonic() + 5.0
            while self.signals_seen < 2 and time.monotonic() < deadline:
                time.sleep(0.005)

    handler = Handler(None, exit_on_preempt=False).install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not handler.preempted and time.monotonic() < deadline:
            time.sleep(0.005)
        assert handler.preempted and handler.signals_seen == 2 and calls["n"] == 1
    finally:
        handler.uninstall()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")


def _engine(model):
    return ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(16,))


def _requests():
    r = np.random.default_rng(3)
    return [Request(r.integers(0, 256, n).tolist(),
                    SamplingParams(max_new_tokens=10, temperature=0.9 if i % 2 else 0.0,
                                   top_k=5 if i % 2 else None, seed=50 + i))
            for i, n in enumerate((5, 9, 12, 4))]


def _uninterrupted(model):
    return {o.request_id: o.tokens for o in _engine(model).run(_requests())}


def _sigterm_and_wait(handler):
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.monotonic() + 10.0
    while not handler.preempted and time.monotonic() < deadline:
        time.sleep(0.005)
    assert handler.preempted


def test_sigterm_drains_then_snapshots_and_a_fresh_engine_resumes(model, tmp_path):
    """grace 0: the drain runs out at once with every request left, so the
    handler snapshots; a fresh engine resumes the snapshot to the
    uninterrupted streams. Submits are rejected while the handler drains,
    and accepted again once it returns."""
    want = _uninterrupted(model)
    engine = _engine(model)
    for r in _requests():
        assert engine.submit(r).accepted
    for _ in range(3):
        engine.step()  # two streams mid-decode, two queued
    snap = tmp_path / "engine.snap"
    handler = install_serving_preemption_handler(engine, str(snap), grace_s=0.0,
                                                 exit_on_preempt=False)
    try:
        _sigterm_and_wait(handler)
    finally:
        handler.uninstall()
    assert handler.snapshotted and handler.checkpoint_dir == str(snap)
    assert snap.is_file() and SNAPSHOT_FORMAT in snap.read_text()
    assert not engine.draining  # re-opened after the handler's drain
    done = {o.request_id: o.tokens for o in handler.drained}
    fresh = _engine(model)
    report = fresh.resume(snap)
    assert report.source == "snapshot" and report.resumed and report.restored
    while fresh.has_work:
        for out in fresh.step():
            done[out.request_id] = out.tokens
    assert done == want


def test_sigterm_with_room_to_drain_writes_no_snapshot(model, tmp_path):
    want = _uninterrupted(model)
    engine = _engine(model)
    for r in _requests():
        assert engine.submit(r).accepted
    engine.step()
    handler = ServingPreemptionHandler(engine, str(tmp_path / "never.snap"), grace_s=60.0,
                                       exit_on_preempt=False).install()
    try:
        _sigterm_and_wait(handler)
    finally:
        handler.uninstall()
    assert not handler.snapshotted and not (tmp_path / "never.snap").exists()
    assert not engine.has_work
    assert {o.request_id: o.tokens for o in handler.drained} == want


def test_injected_preemption_reaches_the_serving_handler(model, tmp_path):
    """`FaultSpec.preempt` delivers a real SIGTERM, as the reference's test
    does with its training handler."""
    engine = _engine(model)
    engine.submit(_requests()[0])
    handler = ServingPreemptionHandler(engine, str(tmp_path / "s.snap"), grace_s=60.0,
                                       exit_on_preempt=False).install()
    try:
        inj = FaultInjector(specs=[FaultSpec.preempt(at_calls=(0,))])
        assert inj.maybe_preempt()
        deadline = time.monotonic() + 10.0
        while not handler.preempted and time.monotonic() < deadline:
            time.sleep(0.005)
        assert handler.preempted and len(handler.drained) == 1
    finally:
        handler.uninstall()
