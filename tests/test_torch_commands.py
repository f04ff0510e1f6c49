"""The port's commands against the reference's, on the CPU:

- ``env`` prints the reference's fields from PyTorch and invents no card;
- ``estimate-memory``: the counts and the printed table equal the
  reference's ``estimate_parameters`` and ``estimate_command`` for the three
  GPT-2 sizes, plain and with ``--fsdp 2 --tensor 2``; an unknown name is
  the reference's ValueError (offline: nothing is downloaded);
- `commands.menu.choose` with scripted keys equals the reference's, and the
  ``config`` questionnaire goes through it;
- ``test`` runs `test_utils.test_script` at one CPU process in this process,
  and at two gloo ranks through the launcher (one spawn);
- the config templates' ``run_me.py`` with ``single_chip.yaml`` and
  ``fp8.yaml``: the resolved mesh, and the step's loss held to the
  reference's ``run_me.py`` on the same key-0 weights and ids; under fp8 the
  block projections are `ops.fp8.Fp8Linear` and their scaling state moved;
- ``python -m accelerate_tpu_torch.commands.cli`` has the six commands.
"""

import argparse
import contextlib
import functools
import importlib.util
import io
import math
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

pytest.importorskip("jax")

from accelerate_tpu.commands import estimate as jestimate  # noqa: E402
from accelerate_tpu.commands import menu as jmenu  # noqa: E402
from accelerate_tpu_torch.commands import cli, config, estimate, menu  # noqa: E402
from accelerate_tpu_torch.commands.launch import launch_env, scrubbed_environ  # noqa: E402
from accelerate_tpu_torch.commands.test import SUCCESS  # noqa: E402
from accelerate_tpu_torch.examples.config_yaml_templates import run_me  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2LMHead  # noqa: E402
from accelerate_tpu_torch.ops.fp8 import Fp8Linear  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
TEMPLATES = ROOT / "accelerate_tpu_torch" / "examples" / "config_yaml_templates"
GPT2_NAMES = ("gpt2", "gpt2-medium", "gpt2-large")
# one spawn of two gloo ranks: its own bound, well inside the suite's
SPAWN_TIMEOUT_S = 120


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def test_cli_has_the_six_commands():
    out = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.cli", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=60, check=True).stdout
    for name in ("config", "config-update", "env", "estimate-memory", "launch", "test"):
        assert name in out, name
    assert "merge-weights" not in out and "tpu-config" not in out


def test_env_reports_torch_and_invents_no_card(monkeypatch):
    monkeypatch.setattr("shutil.which", lambda name: None)  # no nvidia-smi on the path
    out = _stdout(cli.main, ["env"])
    import torch

    assert f"- torch: {torch.__version__}" in out
    for field in ("CUDA (torch build)", "cuDNN", "devices", "device count", "process_count",
                  "config file"):
        assert f"- {field}: " in out, field
    if not torch.cuda.is_available():
        assert "- devices: no CUDA device" in out and "- nvidia-smi: not found" in out
    assert "power" not in out.lower()


@pytest.mark.parametrize("name", GPT2_NAMES)
def test_estimate_counts_are_the_reference_s(name):
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    n = estimate.estimate_parameters(name)
    assert n == jestimate.estimate_parameters(name)
    size = estimate.GPT2_SIZES[name]
    cfg = getattr(GPT2Config, size)()
    # the count of the port's model: a tied head counts once
    model = GPT2LMHead(cfg, device="meta")
    assert n == sum(p.numel() for p in model.parameters())
    assert n == sum(math.prod(p.shape) for p in dict(model.named_parameters()).values())


@pytest.mark.parametrize("fsdp,tensor", [(1, 1), (2, 2)])
def test_estimate_table_is_the_reference_s(fsdp, tensor):
    for name in GPT2_NAMES:
        dtypes = ["float32", "bf16", "int8"]
        want = _stdout(jestimate.estimate_command,
                       argparse.Namespace(model_name=name, dtypes=dtypes, fsdp=fsdp, tensor=tensor))
        got = _stdout(estimate.estimate_command,
                      argparse.Namespace(model_name=[name], dtypes=dtypes, fsdp=fsdp, tensor=tensor))
        assert got == want
    both = _stdout(cli.main, ["estimate-memory", *GPT2_NAMES, "--fsdp", str(fsdp),
                              "--tensor", str(tensor)])
    assert both.count("Model: gpt2") == 3


def test_estimate_unknown_name_is_the_reference_s_value_error(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(ValueError, match="Unknown model 'no-such-model-anywhere'"):
        estimate.estimate_parameters("no-such-model-anywhere")


KEYS = [[menu.ENTER], [menu.DOWN, menu.DOWN, menu.ENTER], [menu.UP, menu.ENTER],
        ["j", "j", "k", menu.ENTER], ["3", menu.ENTER], ["9", menu.DOWN, menu.ENTER]]


@pytest.mark.parametrize("keys", KEYS, ids=lambda k: "-".join(k))
def test_menu_choose_with_scripted_keys_is_the_reference_s(keys):
    choices = ["no", "bf16", "fp16", "fp8"]
    got = menu.choose("Mixed precision", choices, "bf16", key_reader=iter(keys).__next__)
    want = jmenu.choose("Mixed precision", choices, "bf16", key_reader=iter(keys).__next__)
    assert got == want


def test_menu_interrupt_raises():
    with pytest.raises(KeyboardInterrupt):
        menu.choose("x", ["a", "b"], "a", key_reader=iter([menu.INTERRUPT]).__next__)


def test_config_questionnaire_goes_through_the_menu(monkeypatch, tmp_path):
    keys = iter([menu.DOWN, menu.DOWN, menu.ENTER])  # bf16 -> fp16 -> fp8
    monkeypatch.setattr(menu, "choose", functools.partial(menu.choose, key_reader=keys.__next__))
    typed = iter(["2", "4"])  # processes, accumulation steps
    monkeypatch.setattr("builtins.input", lambda prompt="": next(typed))
    path = tmp_path / "cfg.yaml"
    _stdout(config.config_command, argparse.Namespace(config_file=str(path), default=False))
    saved = yaml.safe_load(path.read_text())
    assert (saved["num_processes"], saved["mixed_precision"],
            saved["gradient_accumulation_steps"]) == (2, "fp8", 4)


def test_cli_test_at_one_cpu_process(monkeypatch, tmp_path):
    # the command puts the config's variables in the environment: pin them
    # to the defaults here so the test leaves this process as it found it
    for key, value in launch_env(config.LaunchConfig()).items():
        monkeypatch.setenv(key, value)
    out = _stdout(cli.main, ["test", "--device", "cpu", "--config_file", str(tmp_path / "none.yaml")])
    assert "1 process(es)" in out and out.rstrip().endswith(SUCCESS)
    assert out.count(": OK") == 12


def test_cli_test_at_two_gloo_ranks_through_the_launcher(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.launch", "--debug_cpu", "2",
         "-m", "accelerate_tpu_torch.commands.cli", "test",
         "--config_file", str(tmp_path / "none.yaml")],
        cwd=ROOT, capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S,
        env={**scrubbed_environ(), "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count(SUCCESS) == 2
    assert out.stdout.count("2 process(es)") == 2
    for name in ("test_multiprocess_ops", "test_sync", "test_dispatcher", "test_metrics"):
        assert out.stdout.count(f"launched-script chain [{name}]: OK") == 2, name


# the step's loss against the reference run_me's on the same key-0 weights
# and ids: bf16 compute on both sides (measured 9.5e-7 apart); under fp8 the
# port's block projections run in e4m3 while the reference's run_me builds
# none, so its loss is the bf16 one (measured 2.0e-3 apart)
RUN_ME_LOSS_TOL = {"single_chip": 1e-5, "fp8": 1e-2}


@pytest.fixture(scope="module")
def reference_run_me():
    """The reference's `examples/config_yaml_templates/run_me.py` as a
    module, its key-0 weights in the port's names, and a runner that
    returns its printed loss for a template."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead
    from accelerate_tpu.state import AcceleratorState, GradientState, PartialState
    from accelerate_tpu_torch.models.gpt2 import params_from_jax

    spec = importlib.util.spec_from_file_location(
        "reference_run_me", ROOT / "examples" / "config_yaml_templates" / "run_me.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    # the reference run_me's own init: key 0, batch 2, seq 16
    params = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32)).init_params(
        jax.random.key(0), batch=2, seq=16)

    def loss(template, monkeypatch):
        monkeypatch.setattr(sys, "argv", ["run_me", "--config_file",
                                          str(TEMPLATES / f"{template}.yaml")])
        try:
            out = _stdout(module.main)
        finally:
            for state in (AcceleratorState, GradientState, PartialState):
                state._reset_state()
        return float(out.rsplit("loss =", 1)[1])

    return params_from_jax(jax.tree.map(np.asarray, params)), loss


@pytest.mark.parametrize("template", ["single_chip", "fp8"])
def test_run_me_with_the_templates(template, capsys, monkeypatch, reference_run_me):
    weights, reference_loss = reference_run_me
    want = reference_loss(template, monkeypatch)
    capsys.readouterr()

    def with_reference_weights(config, **kwargs):
        # the seeded model, its parameters replaced by the reference's; an
        # fp8 projection's scaling state keeps its initial values
        model = GPT2LMHead(config, **kwargs)
        model.load_state_dict({**model.state_dict(), **weights})
        return model

    monkeypatch.setattr(run_me, "GPT2LMHead", with_reference_weights)
    got = run_me.main(["--config_file", str(TEMPLATES / f"{template}.yaml"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert got["mixed_precision"] == {"single_chip": "bf16", "fp8": "fp8"}[template]
    assert got["mesh"] == {"data": 1, "fsdp": 1, "stage": 1, "sequence": 1, "tensor": 1}
    assert math.isfinite(got["loss"]) and abs(got["loss"] - want) < RUN_ME_LOSS_TOL[template]
    assert "mesh: {'data': 1" in out and "one step ok, loss =" in out
    # the optimizer took the step: AdamW's first update moves each
    # parameter's largest element by lr = 1e-3 (|m / sqrt(v)| = 1 at step
    # one), plus lr * 0.01 * |w| of weight decay (at most 1.01e-3 here)
    for name, p in got["model"].named_parameters():
        moved = float((p.detach() - weights[name]).abs().max())
        assert 0.99e-3 < moved < 1.02e-3, (name, moved)
    # fp8: every block projection is an Fp8Linear, and the step moved each
    # one's delayed-scaling state
    fp8 = [m for m in got["model"].modules() if isinstance(m, Fp8Linear)]
    n_layer = got["model"].config.n_layer
    assert len(fp8) == {"single_chip": 0, "fp8": 4 * n_layer}[template]
    for m in fp8:
        assert float(m.input_amax_history.abs().max()) > 0
        assert float(m.kernel_amax_history.abs().max()) > 0
