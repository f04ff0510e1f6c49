"""The port's `examples/cv_example.py` against the reference's, on the CPU.

The reference's ``training_function`` runs as it is written, ``--tiny``
(`ResNetConfig.tiny` at 32 x 32, 3 epochs of 8 batches of 16, SGD with
momentum 0.9 at lr 0.02), except that its config computes in fp32 (the tiny
config's convolutions are bf16). The port's ``training_function`` takes the
same weights (`params_from_jax` of the reference's seeded init) and the
same synthetic images: every microbatch's loss and each epoch's accuracy
are compared. Then the example runs from the command line."""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from accelerate_tpu.models.resnet import ResNetConfig as JaxResNetConfig  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.examples import cv_example  # noqa: E402
from accelerate_tpu_torch.models.resnet import ResNetConfig, params_from_jax  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
SEED = 42
# fp32 both sides, 24 SGD-momentum updates: the losses part by summation
# order in the convolutions and GroupNorm statistics
LOSS_ATOL = 1e-4


class _Float32Config(JaxResNetConfig):
    """The reference's config with fp32 convolutions."""

    @classmethod
    def tiny(cls, **kw):
        return dataclasses.replace(JaxResNetConfig.tiny(**kw), dtype=jnp.float32)


def _reference_example():
    spec = importlib.util.spec_from_file_location("reference_cv_example",
                                                  ROOT / "examples" / "cv_example.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runs():
    ref = _reference_example()
    seen = {"losses": [], "lines": []}

    class Recording(JaxAccelerator):
        def make_train_step(self, loss_fn, **kw):
            step = super().make_train_step(loss_fn, **kw)

            def recorded(batch):
                loss = step(batch)
                seen["losses"].append(float(loss))
                return loss

            return recorded

        def print(self, *args, **kwargs):
            seen["lines"].append(" ".join(map(str, args)))

    ref.Accelerator = Recording
    ref.ResNetConfig = _Float32Config
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    args = cv_example.parser().parse_args(["--tiny", "--device", "cpu"])
    ref.training_function(args)
    params = JaxResNet(_Float32Config.tiny()).init_params(jax.random.key(SEED), image_size=32)
    got = cv_example.training_function(
        args, config=ResNetConfig.tiny(dtype=torch.float32),
        weights=params_from_jax(jax.tree.map(np.asarray, params)))
    return seen, got


def test_every_microbatch_loss_matches(runs):
    want, got = runs
    assert len(got["losses"]) == len(want["losses"]) == 24
    np.testing.assert_allclose(got["losses"], want["losses"], atol=LOSS_ATOL, rtol=0)
    assert got["losses"][-1] < got["losses"][0]


def test_each_epoch_prints_the_reference_s_accuracy(runs):
    want, got = runs
    accuracies = [float(line.rsplit("=", 1)[1]) for line in want["lines"]]
    assert [round(e["accuracy"], 3) for e in got["epochs"]] == accuracies
    assert got["epochs"][-1]["accuracy"] > 0.1  # ten classes: chance is 0.1


def test_example_runs_from_the_command_line():
    out = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch.examples.cv_example", "--tiny", "--device",
         "cpu", "--num_epochs", "2", "--mixed_precision", "bf16"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})  # one thread, as tests/torch_threads.py
    lines = out.stdout.splitlines()
    assert [line.split(":")[0] for line in lines] == ["epoch 0", "epoch 1"]
    assert all(np.isfinite(float(line.split("loss=")[1].split()[0])) for line in lines)


def test_complete_cv_example_resumed_from_epoch_0_retraces_the_later_epochs(tmp_path):
    """``--checkpointing --with_tracking`` saves ``epoch_<e>`` each epoch; a
    run resumed from ``epoch_0`` trains every epoch again from there, and
    its first two epochs give the unbroken run's epochs 1 and 2 bit for
    bit (the batches repeat each epoch, and the schedule's position comes
    back with the checkpoint)."""
    from accelerate_tpu_torch.examples import complete_cv_example as ccv

    base = ["--tiny", "--device", "cpu", "--num_epochs", "3"]
    full = ccv.training_function(ccv.parser().parse_args(
        base + ["--checkpointing", "--with_tracking", "--project_dir", str(tmp_path / "a")]))
    assert [c["dir"].rsplit("/", 1)[1] for c in full["checkpoints"]] == \
        ["epoch_0", "epoch_1", "epoch_2"]
    assert all(c["bytes"] > 0 for c in full["checkpoints"])
    resumed = ccv.training_function(ccv.parser().parse_args(
        base + ["--project_dir", str(tmp_path / "b"),
                "--resume_from_checkpoint", full["checkpoints"][0]["dir"]]))
    assert resumed["losses"][:16] == full["losses"][8:]
    tracked = (tmp_path / "a" / "complete_cv_example.metrics.jsonl").read_text().splitlines()
    assert len(tracked) == 4  # the config, then one line an epoch


def test_complete_nlp_example_resumes_by_epoch_and_by_step(tmp_path):
    from accelerate_tpu_torch.examples import complete_nlp_example as cnlp

    base = ["--tiny", "--device", "cpu", "--num_epochs", "2", "--project_dir", str(tmp_path)]
    full = cnlp.training_function(cnlp.parser().parse_args(
        base + ["--checkpointing_steps", "step", "--save_every", "4"]))
    by_step = cnlp.training_function(cnlp.parser().parse_args(
        base + ["--resume_from_checkpoint", str(tmp_path / "checkpoints" / "step_12")]))
    assert by_step["starting_epoch"] == 1 and by_step["losses"] == full["losses"][12:]
    cnlp.training_function(cnlp.parser().parse_args(base + ["--checkpointing_steps", "epoch"]))
    by_epoch = cnlp.training_function(cnlp.parser().parse_args(
        base + ["--resume_from_checkpoint", str(tmp_path / "checkpoints" / "epoch_0")]))
    assert by_epoch["starting_epoch"] == 1 and by_epoch["losses"] == full["losses"][8:]
