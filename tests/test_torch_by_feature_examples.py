"""The port's `examples/by_feature/` (`accelerate_tpu_torch.examples.by_feature`)
against the reference's, on the CPU.

Every ported example runs from the command line, ``--tiny --num_epochs 1
--device cpu``, and exits 0 (all at once, one process each). Four of them,
`gradient_accumulation`, `checkpointing`, `early_stopping` and
`cross_validation`, run beside the reference's script of the same name, in
this process, from the same weights (both draw the MLP's weights from
numpy's ``default_rng``, and `_common.params_from_jax` carries the
reference's tree): every train step's loss agrees, and the early stop lands
on the same step. A roster names each reference example the port has not
taken and why."""

import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.examples.by_feature import _common  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "examples" / "by_feature"
PORT = ROOT / "accelerate_tpu_torch" / "examples" / "by_feature"
PORTED = ("gradient_accumulation", "checkpointing", "automatic_gradient_accumulation",
          "early_stopping", "memory", "profiler", "tracking", "cross_validation",
          "sliding_window_long_context")
# the reference's examples the port has not taken, each with its reason
DEFERRED = {
    "schedule_free": "needs a port of optax.contrib.schedule_free_adamw (ROADMAP item 34.1)",
    **{name: "multi-process: waits for the torch.distributed runtime (ROADMAP item 21.3)"
       for name in ("ddp_comm_hook", "local_sgd", "multi_process_metrics",
                    "fsdp_with_peak_mem_tracking", "deepspeed_dummy_optim_scheduler",
                    "deepspeed_with_config_support", "tensor_parallel_gpt_pretraining",
                    "pipeline_parallel_training", "moe_expert_parallel")},
}
# fp32 both sides, a handful of Adam steps on a 2-layer MLP: summation order
LOSS_ATOL = 1e-5


def test_roster_names_every_reference_example():
    reference = {p.stem for p in REFERENCE.glob("*.py") if not p.name.startswith("_")}
    port = {p.stem for p in PORT.glob("*.py") if not p.name.startswith("_")}
    assert port == set(PORTED)
    assert reference == set(PORTED) | set(DEFERRED)
    assert all("ROADMAP item" in why for why in DEFERRED.values())


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every ported example from the command line, all started together."""
    procs = {}
    for name in PORTED:
        out = tmp_path_factory.mktemp(name)
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", f"accelerate_tpu_torch.examples.by_feature.{name}", "--tiny",
             "--num_epochs", "1", "--device", "cpu", "--project_dir", str(out)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "OMP_NUM_THREADS": "1"}))  # one thread, as tests/torch_threads.py
    done = {}
    for name, (out, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        done[name] = (proc.returncode, stdout, stderr, out)
    return done


@pytest.mark.parametrize("name", PORTED)
def test_example_runs_from_the_command_line(cli_runs, name):
    rc, stdout, stderr, out = cli_runs[name]
    assert rc == 0, f"{name}:\n{stdout}\n{stderr}"
    assert "accuracy" in stdout or "loss" in stdout, stdout
    if name == "checkpointing":
        assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["checkpoint_0"]
        assert "restore parity" in stdout
    if name == "profiler":
        assert list(out.glob("trace_*.json"))
    if name == "tracking":
        assert (out / "tracking_example.metrics.jsonl").exists()
        assert list((out / "tracking_example.media").glob("*.npy"))


def test_mlp_weights_carry_from_the_reference_tree():
    model = _common.make_model(3, "cpu")
    params = _common.init_params(3)
    x = np.random.default_rng(0).normal(size=(5, _common.FEATURES)).astype(np.float32)
    want = np.tanh(x @ params["w1"] + params["b1"]) @ params["w2"] + params["b2"]
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(), want, atol=1e-6)


def _reference_losses(name, argv, monkeypatch):
    """Run the reference's script ``name`` in this process with ``argv``;
    return every train step's loss, in order, over all its accelerators."""
    # the script puts its own directory on sys.path: undone after the test
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"reference_{name}", REFERENCE / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    losses = []

    class Recording(JaxAccelerator):
        def make_train_step(self, loss_fn, **kw):
            step = super().make_train_step(loss_fn, **kw)

            def recorded(batch):
                loss = step(batch)
                losses.append(float(loss))
                return loss

            return recorded

    module.Accelerator = Recording
    for state in (AcceleratorState, GradientState, PartialState):
        state._reset_state()
    monkeypatch.setattr(sys, "argv", [name, *argv])
    module.main()
    return losses


def _port_main(name):
    return importlib.import_module(f"accelerate_tpu_torch.examples.by_feature.{name}").main


CASES = {
    "gradient_accumulation": ["--tiny", "--num_epochs", "2"],
    "checkpointing": ["--tiny", "--num_epochs", "2"],
    "early_stopping": ["--tiny", "--lr", "0.05"],
    "cross_validation": ["--tiny", "--num_epochs", "2"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_hold_the_reference_s(name, tmp_path, monkeypatch):
    argv = CASES[name] + ["--project_dir", str(tmp_path / "ref")]
    want = _reference_losses(name, argv, monkeypatch)
    got = _port_main(name)(CASES[name] + ["--project_dir", str(tmp_path / "port"),
                                          "--device", "cpu"])
    losses = [x for fold in got["fold_losses"] for x in fold] if "fold_losses" in got \
        else got["losses"]
    assert len(losses) == len(want) > 0
    np.testing.assert_allclose(losses, want, atol=LOSS_ATOL, rtol=0)
    if name == "early_stopping":
        assert got["stopped_at"] is not None and losses[-1] < 0.2  # the trigger fired
