"""The port's `examples/nlp_example.py` loop against the reference's, on the
CPU.

The reference's example, run as it is written but on
`BertConfig.tiny(dtype=float32)` (its tiny config computes in bf16), and the
port's `accelerate_tpu_torch.examples.nlp_example.training_function` on the
same weights (`params_from_jax`) and the same synthetic batches: fp32,
``gradient_accumulation_steps=3`` over 8 batches an epoch (boundaries at
batches 3, 6 and 8), 3 epochs, global-norm clipping at 1.0. Every
microbatch's loss, the eval predictions and accuracy of each epoch, and the
lr of every applied update (against optax's schedule) are compared. Then
the example runs from the command line."""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.data_loader import DataLoaderShard as JaxDataLoaderShard  # noqa: E402
from accelerate_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from accelerate_tpu.models.bert import BertForSequenceClassification as JaxBert  # noqa: E402
from accelerate_tpu.models.bert import classification_loss_fn as jax_loss_fn  # noqa: E402
from accelerate_tpu.scheduler import OptaxSchedule  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.examples import nlp_example  # noqa: E402
from accelerate_tpu_torch.models.bert import BertConfig, params_from_jax  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
K, EPOCHS, BATCH, SEED, LR = 3, 3, 16, 42, 5e-4
# fp32 on both sides, 9 AdamW updates: the losses differ by summation order
# in the forward and by Adam's m / sqrt(v) amplifying gradient differences
# where a gradient is tiny; the largest difference read was 2.1e-6
LOSS_ATOL = 2e-5
# optax evaluates its schedule in fp32, the port in Python floats
LR_RTOL = 1e-6


def _reference_example():
    spec = importlib.util.spec_from_file_location("reference_nlp_example",
                                                  ROOT / "examples" / "nlp_example.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runs():
    """The reference's loop and the port's, on the same weights."""
    ref = _reference_example()
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    jacc = JaxAccelerator(mixed_precision="no", gradient_accumulation_steps=K)
    jmod = JaxBert(JaxBertConfig.tiny(dtype=jnp.float32))
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(SEED)))
    train, evals = ref.get_dataloaders(BATCH, 1024, SEED)
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=4,
                                                  decay_steps=len(train) * EPOCHS)
    model, _, train_dl, eval_dl, sched = jacc.prepare(
        (jmod, params), optax.adamw(schedule), JaxDataLoaderShard(train),
        JaxDataLoaderShard(evals), OptaxSchedule(schedule))
    step = jacc.make_train_step(jax_loss_fn, max_grad_norm=1.0)
    want = {"losses": [], "preds": [], "accuracy": [], "syncs": []}
    for _ in range(EPOCHS):
        for batch in train_dl:
            want["losses"].append(float(step(batch)))
            want["syncs"].append(jacc.sync_gradients)
            sched.step()
        correct = total = 0
        preds = []
        for batch in eval_dl:
            logits = model(batch["input_ids"], batch["attention_mask"])
            g = jacc.gather_for_metrics({"preds": jnp.argmax(logits, axis=-1),
                                         "labels": batch["labels"]})
            correct += int((np.asarray(g["preds"]) == np.asarray(g["labels"])).sum())
            total += len(np.asarray(g["labels"]))
            preds += np.asarray(g["preds"]).tolist()
        want["accuracy"].append(correct / total)
        want["preds"].append(preds)
    want["updates"] = sched.scheduler.count

    args = nlp_example.parser().parse_args(
        ["--tiny", "--device", "cpu", "--gradient_accumulation_steps", str(K)])
    got = nlp_example.training_function(args, config=BertConfig.tiny(dtype=torch.float32),
                                        weights=params_from_jax(params))
    return want, got, schedule


def test_every_microbatch_loss_matches(runs):
    want, got, _ = runs
    assert len(got["losses"]) == len(want["losses"]) == 8 * EPOCHS
    np.testing.assert_allclose(got["losses"], want["losses"], atol=LOSS_ATOL, rtol=0)
    # boundaries at batches 3, 6 and 8 of each epoch: the last batch closes the window
    assert want["syncs"] == [False, False, True, False, False, True, False, True] * EPOCHS


def test_eval_predictions_and_accuracy_match(runs):
    want, got, _ = runs
    assert [e["accuracy"] for e in got["epochs"]] == want["accuracy"]
    assert got["preds"] == want["preds"][-1]
    assert got["epochs"][-1]["accuracy"] > 0.9  # the synthetic task is separable


def test_lr_of_every_applied_update_is_optax(runs):
    want, got, schedule = runs
    assert len(got["lrs"]) == want["updates"] == 3 * EPOCHS
    np.testing.assert_allclose(got["lrs"], [float(schedule(n)) for n in range(len(got["lrs"]))],
                               rtol=LR_RTOL, atol=0)
    assert got["lrs"][0] == 0.0  # optax reads the count before it increments
    assert got["scheduler"].scheduler.last_epoch == want["updates"]


def test_example_runs_from_the_command_line(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch.examples.nlp_example", "--tiny", "--device",
         "cpu", "--num_epochs", "2", "--gradient_accumulation_steps", "2", "--with_tracking",
         "--checkpointing", "--project_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})  # one thread, as tests/torch_threads.py
    assert [line.split(":")[0] for line in out.stdout.splitlines()] == ["epoch 0", "epoch 1"]
    lines = [json.loads(x) for x in (tmp_path / "nlp_example.metrics.jsonl").read_text().splitlines()]
    assert lines[0]["_config"]["gradient_accumulation_steps"] == 2
    assert [x["_step"] for x in lines[1:]] == [0, 1]
    assert (tmp_path / "checkpoints" / "_COMPLETE").exists()


def test_fp16_example_runs():
    """fp16 through the scaler: the loss stays finite and falls."""
    args = argparse.Namespace(**{**vars(nlp_example.parser().parse_args(["--tiny", "--device",
                                                                           "cpu"])),
                                 "mixed_precision": "fp16", "num_epochs": 2})
    run = nlp_example.training_function(args)
    assert all(np.isfinite(run["losses"]))
    assert run["optimizer"].num_updates == 16
    assert run["accelerator"].scaler is not None
    assert run["losses"][-1] < run["losses"][0]
