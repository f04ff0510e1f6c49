"""The port's `Accelerator` facade against the reference's, on the CPU: the
imperative loop (``accumulate``, ``backward``, ``clip_grad_norm_``,
``optimizer.step()``, ``scheduler.step()``) against the reference's and
against the port's own ``make_train_step``; optax's schedule through
`LambdaLR`; the fp16 scaler's trajectory under injected infs and the
skipped update; the JSONL tracker's lines and ``log_with`` selection; the
prepared model's eval forward; ``prepare`` in any order; the process
predicates."""

import json
import logging

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu import tracking as jax_tracking  # noqa: E402
from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.data_loader import DataLoaderShard as JaxDataLoaderShard  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.models.gpt2 import lm_loss_fn as jax_lm_loss_fn  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu.utils.precision import DynamicGradScaler as JaxScaler  # noqa: E402
from accelerate_tpu.utils.precision import GradScalerState as JaxScalerState  # noqa: E402
from accelerate_tpu_torch import tracking  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator, BoundModel, PreparedModel  # noqa: E402
from accelerate_tpu_torch.data_loader import DataLoaderShard  # noqa: E402
from accelerate_tpu_torch.models.bert import (  # noqa: E402
    BertConfig,
    BertForSequenceClassification,
    classification_loss_fn,
)
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, lm_loss_fn, params_from_jax  # noqa: E402
from accelerate_tpu_torch.scheduler import (  # noqa: E402
    AcceleratedScheduler,
    OptaxSchedule,
    schedule_lambda,
    warmup_cosine_decay_schedule,
)
from accelerate_tpu_torch.utils.precision import DynamicGradScaler  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

K = 2
# fp32 on both sides; 2 AdamW updates at lr 1e-2 (see tests/test_torch_train.py)
LOSS_ATOL = 1e-5
PARAM_ATOL = 5e-4


def _jax_accelerator(**kwargs):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    return JaxAccelerator(**kwargs)


@pytest.fixture(scope="module")
def gpt2():
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32, attention_impl="xla"))
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0), batch=1, seq=8))
    r = np.random.default_rng(1)
    batches = [{"input_ids": r.integers(0, 256, (4, 16)).astype(np.int32)} for _ in range(5)]
    return jmod, params, batches


def _port_gpt2(params):
    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32, attention_impl="xla"), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _explicit_loop(acc, model, opt, sched, dl, loss_fn, max_norm=0.5):
    losses = []
    for batch in dl:
        with acc.accumulate(model):
            loss = acc.backward(loss_fn, batch)
            if acc.sync_gradients:
                acc.clip_grad_norm_(max_norm=max_norm)
            opt.step()
            if sched is not None:
                sched.step()
            opt.zero_grad()
        losses.append(float(loss))
    return losses


def test_explicit_loop_matches_reference_and_make_train_step(gpt2):
    """5 microbatches with k=2: boundaries at 2, 4 and 5 (the epoch's end),
    clipping at 0.5; optax ``adamw(1e-2)`` against torch ``AdamW(lr=1e-2,
    weight_decay=1e-4)``. The port's two forms give equal bits."""
    jmod, params, batches = gpt2
    jacc = _jax_accelerator(gradient_accumulation_steps=K)
    jmodel, jopt, jdl = jacc.prepare((jmod, params), optax.adamw(1e-2),
                                     JaxDataLoaderShard(batches))
    want_losses = _explicit_loop(jacc, jmodel, jopt, None, jdl, jax_lm_loss_fn)
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))

    runs = {}
    for form in ("explicit", "fused"):
        acc = Accelerator(gradient_accumulation_steps=K, device="cpu")
        module = _port_gpt2(params)
        model, opt, dl = acc.prepare(
            module, torch.optim.AdamW(module.parameters(), lr=1e-2, weight_decay=1e-4),
            DataLoaderShard(batches))
        if form == "explicit":
            losses = _explicit_loop(acc, model, opt, None, dl, lm_loss_fn)
        else:
            step = acc.make_train_step(lm_loss_fn, max_grad_norm=0.5)
            losses = [step(b).item() for b in dl]
        assert opt.num_updates == 3
        runs[form] = (losses, {n: p.detach().clone() for n, p in module.named_parameters()})
    np.testing.assert_allclose(runs["explicit"][0], want_losses, atol=LOSS_ATOL, rtol=0)
    for name, p in runs["explicit"][1].items():
        if name.endswith("attn.qkv.bias"):
            continue  # the key third's gradient is rounding noise (tests/test_torch_train.py)
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
    assert runs["explicit"][0] == runs["fused"][0]
    for name, p in runs["explicit"][1].items():
        assert torch.equal(p, runs["fused"][1][name]), name


def test_backward_scales_by_one_over_k_and_returns_aux():
    acc = Accelerator(gradient_accumulation_steps=4, device="cpu")
    module = torch.nn.Linear(3, 1, device="cpu")
    model, _ = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.1))
    x = torch.ones(2, 3)

    def loss_fn(bound, batch):
        assert isinstance(bound, BoundModel)
        return bound(batch).sum(), "aux"

    loss, aux = acc.backward(loss_fn, x)
    assert aux == "aux" and loss.requires_grad is False
    np.testing.assert_allclose(module.weight.grad.numpy(), np.full((1, 3), 2 / 4))
    acc.backward(loss_fn, x)
    np.testing.assert_allclose(module.weight.grad.numpy(), np.full((1, 3), 4 / 4))
    acc.clip_grad_value_(clip_value=0.25)
    assert module.weight.grad.max().item() == 0.25
    with acc.no_sync(model):
        assert not acc.sync_gradients
    acc.trigger_sync_in_backward(model)
    assert acc.sync_gradients


@pytest.mark.parametrize("warmup,decay,end", [(4, 24, 0.0), (0, 10, 1e-5), (3, 9, 2e-4)])
def test_schedule_equals_optax_at_every_update(warmup, decay, end):
    want = optax.warmup_cosine_decay_schedule(0.0, 5e-4, warmup_steps=warmup, decay_steps=decay,
                                              end_value=end)
    got = warmup_cosine_decay_schedule(0.0, 5e-4, warmup_steps=warmup, decay_steps=decay,
                                       end_value=end)
    counts = range(decay + 4)
    # optax evaluates in fp32: within a few fp32 ulps of the value, and of
    # the peak where the cosine nears 0 (the largest reading: 5.4e-12)
    np.testing.assert_allclose([got(n) for n in counts], [float(want(n)) for n in counts],
                               rtol=1e-6, atol=4 * 2**-23 * 5e-4)
    # through LambdaLR, once per applied update: update n runs at schedule(n)
    param = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.AdamW([param])
    sched = schedule_lambda(opt, got)
    applied = []
    for _ in counts:
        applied.append(opt.param_groups[0]["lr"])
        sched.step()
    assert applied == [got(n) for n in counts]
    adapter = OptaxSchedule(got)
    adapter.step()
    assert adapter.get_last_lr() == [got(1)] and adapter.state_dict() == {"count": 1}


def test_scaler_trajectory_under_injected_infs_matches_reference():
    """The same gradients through both scalers (growth every 2 finite
    boundaries, an inf at boundaries 2 and 5, a nan at 6): equal flags,
    scales and trackers, and equal unscaled gradients."""
    jscaler, scaler = JaxScaler(growth_interval=2), DynamicGradScaler(growth_interval=2)
    jstate, state = jscaler.init(), scaler.init("cpu")
    r = np.random.default_rng(0)
    for i in range(9):
        g = [r.standard_normal((3, 4)).astype(np.float32) * 1000, r.standard_normal(5).astype(np.float32)]
        if i in (2, 5):
            g[0][1, 2] = np.inf
        if i == 6:
            g[1][0] = np.nan
        jg, jstate, jfinite = jscaler.unscale_and_update([jnp.asarray(x) for x in g], jstate)
        tg = [torch.from_numpy(x.copy()) for x in g]
        state, finite = scaler.unscale_and_update(tg, state)
        assert bool(finite) == bool(jfinite) == (i not in (2, 5, 6))
        assert state.scale.item() == float(jstate.scale)
        assert state.growth_tracker.item() == int(jstate.growth_tracker)
        if bool(finite):
            for a, b in zip(tg, jg):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    inner, outer = scaler.split_scale(torch.tensor(2.0**15))
    assert inner.item() == 2.0**10 and outer.item() == 2.0**5
    capped = scaler.update_state(type(state)(torch.tensor(2.0**24), torch.tensor(1, dtype=torch.int32)),
                                 torch.tensor(True))
    jcapped = jscaler.update_state(JaxScalerState(jnp.float32(2.0**24), jnp.int32(1)), jnp.bool_(True))
    assert capped.scale.item() == float(jcapped.scale) == 2.0**24


@pytest.mark.parametrize("form", ["explicit", "fused"])
def test_fp16_overflow_skips_the_update_and_the_scheduler(form):
    """BERT tiny in fp16, k=1: the second step's loss is made infinite, so
    its gradients are not finite: the parameters and the lr stay, the scale
    halves, and the next step applies."""
    acc = Accelerator(mixed_precision="fp16", device="cpu")
    module = BertForSequenceClassification(BertConfig.tiny(), device="cpu", seed=0)
    opt = torch.optim.AdamW(module.parameters())
    model, opt, sched = acc.prepare(module, opt, schedule_lambda(opt, lambda n: 1e-3 * (n + 1)))
    assert isinstance(sched, AcceleratedScheduler) and acc.scaler is not None
    r = np.random.default_rng(0)
    batch = {"input_ids": torch.from_numpy(r.integers(0, 1024, (4, 16))),
             "labels": torch.from_numpy(r.integers(0, 2, 4))}
    poison = {"on": False}

    def loss_fn(bound, b):
        loss = classification_loss_fn(bound, b)
        return loss * float("inf") if poison["on"] else loss

    step = acc.make_train_step(loss_fn)

    def run():
        if form == "fused":
            return step(batch)
        with acc.accumulate(model):
            loss = acc.backward(loss_fn, batch)
            opt.step()
            sched.step()
            opt.zero_grad()
        return loss

    run()
    if form == "fused":
        sched.step()
    scale = opt.scaler_state.scale.item()
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    lr = sched.get_last_lr()
    poison["on"] = True
    run()
    if form == "fused":
        sched.step()
    assert opt.step_was_skipped and acc.optimizer_step_was_skipped
    assert opt.num_updates == 1 and opt.skipped_updates == 1
    assert sched.get_last_lr() == lr  # the scheduler did not step past the skipped update
    assert opt.scaler_state.scale.item() == scale / 2
    for name, p in module.named_parameters():
        assert torch.equal(p, before[name]), name
        assert p.grad is None
    poison["on"] = False
    run()
    assert not opt.step_was_skipped and opt.num_updates == 2
    assert any(not torch.equal(p, before[n]) for n, p in module.named_parameters())


def test_jsonl_tracker_lines_equal_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1234.5)
    PartialState._reset_state()
    want = jax_tracking.JSONLTracker("run", logging_dir=str(tmp_path / "ref"))
    got = tracking.JSONLTracker("run", logging_dir=tmp_path / "port")
    config = {"lr": 5e-4, "tiny": True, "name": "x", "dir": None}
    for tracker in (want, got):
        tracker.store_init_configuration(config)
    values = [({"loss": 0.25, "acc": 1.0}, 0), ({"loss": float("nan"), "n": 3}, None),
              ({"vec": [1.5, 2.0], "nested": {"a": 1}}, 7)]
    for vals, step in values:
        want.log({**vals, "t": np.asarray([0.5, 1.25], np.float32)}, step=step)
        got.log({**vals, "t": torch.tensor([0.5, 1.25])}, step=step)
    want.finish()
    got.finish()
    a = (tmp_path / "ref" / "run.metrics.jsonl").read_text()
    b = (tmp_path / "port" / "run.metrics.jsonl").read_text()
    assert a == b and len(b.splitlines()) == 4
    assert json.loads(b.splitlines()[2])["loss"] is None


def test_log_with_selection(tmp_path, monkeypatch, caplog):
    acc = Accelerator(device="cpu", log_with=["jsonl"], project_dir=str(tmp_path))
    acc.init_trackers("proj", config={"a": 1})
    acc.log({"x": 1}, step=0)
    assert acc.get_tracker("jsonl").path == str(tmp_path / "proj.metrics.jsonl")
    acc.end_training()
    assert len((tmp_path / "proj.metrics.jsonl").read_text().splitlines()) == 2
    with pytest.raises(ValueError, match="Unknown tracker"):
        tracking.filter_trackers("nope", None, "p", None, {})
    monkeypatch.setattr(tracking, "_installed", lambda name: False)
    with caplog.at_level(logging.WARNING):
        assert tracking.filter_trackers(["wandb", "tensorboard"], str(tmp_path), "p", None, {}) == []
    assert "wandb requested but not installed" in caplog.text
    monkeypatch.setattr(tracking, "_installed", lambda name: True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, item 33"):
        tracking.filter_trackers("mlflow", None, "p", None, {})
    assert [t.name for t in tracking.filter_trackers("all", str(tmp_path), "q", None, {})] == ["jsonl"]


def test_prepared_model_runs_the_eval_forward_in_the_compute_dtype(gpt2):
    _, params, batches = gpt2
    module = _port_gpt2(params)
    acc = Accelerator(mixed_precision="bf16", device="cpu")
    opt = torch.optim.SGD(module.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.StepLR(opt, 1)
    # any order; the optimizer and scheduler come back wrapped
    sched_p, dl, model, opt_p = acc.prepare(sched, batches, module, opt)
    assert isinstance(model, PreparedModel) and isinstance(dl, DataLoaderShard)
    assert isinstance(sched_p, AcceleratedScheduler) and sched_p.optimizers == [opt_p]
    assert acc.unwrap_model(model) is module and model.config is module.config
    assert [n for n, _ in model.named_parameters()] == [n for n, _ in module.named_parameters()]
    assert model.to("cpu") is module and model.eval() is model and not module.training
    ids = torch.from_numpy(batches[0]["input_ids"])
    with torch.no_grad():
        got = model(ids)
        bf16 = {n: p.to(torch.bfloat16) for n, p in module.named_parameters()}
        want = torch.func.functional_call(module, bf16, (ids,)).float()
        fp32 = module(ids)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert not torch.equal(got, fp32)  # the masters alone would give other logits
    assert model.state_dict().keys() == module.state_dict().keys()


def test_process_predicates_and_printing(capsys):
    acc = Accelerator(device="cpu")
    assert acc.is_main_process and acc.is_local_main_process and acc.is_last_process
    assert acc.num_processes == 1 and acc.process_index == acc.local_process_index == 0
    calls = []
    acc.on_main_process(lambda: calls.append("main"))()
    acc.on_last_process(lambda: calls.append("last"))()
    acc.on_local_main_process(lambda: calls.append("local"))()
    acc.on_process(process_index=1)(lambda: calls.append("one"))()
    acc.on_local_process(local_process_index=0)(lambda: calls.append("local0"))()
    assert calls == ["main", "last", "local", "local0"]
    with acc.main_process_first():
        acc.print("hello")
    acc.wait_for_everyone()
    assert capsys.readouterr().out == "hello\n"
    x = torch.arange(4)
    assert acc.gather(x) is x and acc.reduce(x, scale=2).tolist() == [0, 2, 4, 6]
    assert acc.broadcast(x) is x and acc.pad_across_processes(x) is x
    with pytest.raises(ValueError, match="not parameters of the model"):
        acc.prepare(torch.nn.Linear(2, 2), torch.optim.SGD(torch.nn.Linear(2, 2).parameters(), 0.1))
