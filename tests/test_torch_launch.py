"""The port's launchers: ``python -m accelerate_tpu_torch.commands.launch``,
`launchers.notebook_launcher` and `launchers.debug_launcher`, on the CPU.

- ``--debug_cpu 2`` runs a script and a module, each process with the
  torchrun contract and a gloo group of two;
- a child that fails stops its sibling and its exit code is the launcher's;
  ``--max_restarts 1`` starts the generation again once;
- ``--dry_run`` prints every process's contract and starts nothing; the
  reference's launches across machines raise;
- both launchers run a function at 2 processes and raise with a failed
  worker's traceback;
- a config file the reference's ``config`` command wrote loads;
- the three multi-process by_feature examples (``multi_process_metrics``,
  ``local_sgd``, ``ddp_comm_hook``) run through the launcher at 2
  processes: the eval set is counted once, the losses fall.

One test needs the card (world 1 over NCCL through the launcher) and skips
here.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from accelerate_tpu_torch.commands import launch
from accelerate_tpu_torch.commands.config import LaunchConfig
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LAUNCH = [sys.executable, "-m", "accelerate_tpu_torch.commands.launch"]
TIMEOUT_S = 120
EXAMPLES = {
    "multi_process_metrics": [],
    "local_sgd": ["--local_sgd_steps", "2"],
    "ddp_comm_hook": ["--ddp_comm_hook", "power_sgd"],
}

TOPOLOGY_SCRIPT = """
import json, os, sys
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.utils import operations
acc = Accelerator()
ranks = operations.gather_object([acc.process_index])
out = {"rank": acc.process_index, "world": acc.num_processes, "ranks": ranks,
       "device": str(acc.device), "argv": sys.argv[1:],
       "env": {k: os.environ[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                                          "ACCELERATE_TPU_USE_CPU", "OMP_NUM_THREADS")},
       "leaked": [k for k in os.environ if k.startswith("JAX_")]}
with open(os.path.join(sys.argv[1], f"rank{acc.process_index}.json"), "w") as f:
    json.dump(out, f)
"""


def _env():
    """This process's environment with a variable a launcher must not pass on."""
    return {**os.environ, "PYTHONPATH": str(ROOT), "JAX_COORDINATOR_ADDRESS": "10.0.0.1:1",
            "RANK": "7", "WORLD_SIZE": "9"}


def _run(args, **kw):
    return subprocess.run([*LAUNCH, *args], cwd=ROOT, env=_env(), capture_output=True, text=True,
                          timeout=TIMEOUT_S, **kw)


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    """The three examples through the launcher at 2 processes, all at once."""
    procs = {name: subprocess.Popen(
        [*LAUNCH, "--debug_cpu", "2", "-m", f"accelerate_tpu_torch.examples.by_feature.{name}",
         "--tiny", "--num_epochs", "2", *extra], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, extra in EXAMPLES.items()}
    return {name: (p.communicate(timeout=TIMEOUT_S), p.returncode) for name, p in procs.items()}


def test_debug_cpu_runs_a_script_on_two_ranks(tmp_path):
    script = tmp_path / "topology.py"
    script.write_text(TOPOLOGY_SCRIPT)
    out = _run(["--debug_cpu", "2", str(script), str(tmp_path), "--flag"])
    assert out.returncode == 0, out.stderr
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert (got["rank"], got["world"], got["ranks"], got["device"]) == (r, 2, [0, 1], "cpu")
        assert got["argv"] == [str(tmp_path), "--flag"]
        assert got["env"] == {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
                              "MASTER_ADDR": "127.0.0.1", "ACCELERATE_TPU_USE_CPU": "1",
                              "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}
        assert got["leaked"] == []


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_multi_process_example_through_the_launcher(examples, name):
    (stdout, stderr), rc = examples[name]
    assert rc == 0, f"{stdout}\n{stderr}"
    if name == "multi_process_metrics":
        assert "eval set 151 samples on 2 process(es)" in stdout
    else:
        assert "accuracy=" in stdout
    assert stdout.count("accuracy=") == (2 if name == "ddp_comm_hook" else 1)  # main only


def test_a_failing_child_stops_its_sibling_and_sets_the_exit_code(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys, time
        if os.environ["RANK"] == "1":
            time.sleep(0.5)
            sys.exit(3)
        time.sleep(60)
        open({str(tmp_path / "finished")!r}, "w").close()
        """))
    start = time.monotonic()
    out = _run(["--debug_cpu", "2", "--monitor_interval", "0.1", str(script)])
    assert out.returncode == 3
    assert time.monotonic() - start < 30
    assert not (tmp_path / "finished").exists()


@pytest.mark.parametrize("restarts", [0, 1])
def test_max_restarts_starts_the_generation_again(tmp_path, restarts):
    script = tmp_path / "flaky.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        gen, rank = os.environ["ACCELERATE_TPU_RESTART_COUNT"], os.environ["RANK"]
        if gen == "0" and rank == "1":
            sys.exit(5)
        open(os.path.join({str(tmp_path)!r}, f"gen{{gen}}_rank{{rank}}"), "w").close()
        """))
    out = _run(["--debug_cpu", "2", "--max_restarts", str(restarts), "--monitor_interval", "0.1",
                str(script)])
    if restarts == 0:
        assert out.returncode == 5
        assert not (tmp_path / "gen1_rank0").exists()
    else:
        assert out.returncode == 0, out.stderr
        assert (tmp_path / "gen1_rank0").exists() and (tmp_path / "gen1_rank1").exists()
        assert "restart 1/1" in out.stderr


def test_dry_run_prints_the_contract(tmp_path):
    out = _run(["--debug_cpu", "2", "--main_process_port", "29511", "--mixed_precision", "bf16",
                "--dry_run", "train.py", "--lr", "1"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2
    for r, line in enumerate(lines):
        assert line.startswith(f"rank {r}: ")
        for pair in (f"RANK={r}", f"LOCAL_RANK={r}", "WORLD_SIZE=2", "MASTER_ADDR=127.0.0.1",
                     "MASTER_PORT=29511", "ACCELERATE_TPU_MIXED_PRECISION=bf16",
                     "ACCELERATE_TPU_USE_CPU=1"):
            assert pair in line.split(), (pair, line)
        assert line.endswith("train.py --lr 1")


@pytest.mark.parametrize("flags", [["--workers", "a,b"], ["--num_machines", "2"],
                                   ["--main_process_ip", "10.0.0.2"], ["--sagemaker"]])
def test_launches_across_machines_are_refused(flags):
    with pytest.raises(NotImplementedError, match="item 21.3"):
        launch.main([*flags, "train.py"])


NOTEBOOK = """
import os, sys
from accelerate_tpu_torch.launchers import notebook_launcher
out = sys.argv[1]

def train(tag):  # a closure of the notebook: forked workers need no import
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils import operations
    state = PartialState(device="cpu")
    ranks = operations.gather_object([state.process_index])
    open(os.path.join(out, f"{tag}{state.process_index}_{ranks}"), "w").close()

def broken():
    if os.environ["RANK"] == "1":
        1 / 0

notebook_launcher(train, ("ok",), num_processes=2, use_port="0")
try:
    notebook_launcher(broken, num_processes=2, use_port="0")
except RuntimeError as exc:
    open(os.path.join(out, "error.txt"), "w").write(str(exc))
"""


def test_notebook_launcher_forks_two_workers(tmp_path):
    script = tmp_path / "notebook.py"
    script.write_text(NOTEBOOK)
    env = {k: v for k, v in _env().items() if k not in ("RANK", "WORLD_SIZE")}
    out = subprocess.run([sys.executable, str(script), str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "ok0_[0, 1]").exists() and (tmp_path / "ok1_[0, 1]").exists()
    error = (tmp_path / "error.txt").read_text()
    assert "exit code 1" in error and "ZeroDivisionError" in error and "worker 1" in error


DEBUG_FUNCTIONS = """
import os

def train(out):
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils import operations
    state = PartialState()
    total = operations.reduce(__import__("torch").ones(1), reduction="sum").item()
    open(os.path.join(out, f"rank{state.process_index}_{state.device}_{total}"), "w").close()

def broken():
    raise KeyError("missing " + os.environ["RANK"])
"""


def test_debug_launcher_runs_a_module_function(tmp_path, monkeypatch):
    from accelerate_tpu_torch.launchers import debug_launcher

    module = tmp_path / "functions.py"
    module.write_text(DEBUG_FUNCTIONS)
    monkeypatch.syspath_prepend(str(tmp_path))
    import functions

    debug_launcher(functions.train, (str(tmp_path),), num_processes=2, timeout=TIMEOUT_S)
    assert (tmp_path / "rank0_cpu_2.0").exists() and (tmp_path / "rank1_cpu_2.0").exists()
    with pytest.raises(RuntimeError, match="KeyError") as info:
        debug_launcher(functions.broken, num_processes=2, timeout=TIMEOUT_S)
    assert "exit code 1" in str(info.value)
    with pytest.raises(ValueError, match="module-level"):
        debug_launcher(lambda: None)


def test_a_config_the_reference_wrote_loads(tmp_path):
    yaml = pytest.importorskip("yaml")
    from accelerate_tpu.commands.config import LaunchConfig as JaxLaunchConfig

    path = JaxLaunchConfig(mixed_precision="bf16", gradient_accumulation_steps=4,
                           num_processes=2).to_yaml(tmp_path / "ref.yaml")
    got = LaunchConfig.from_yaml(path)
    assert (got.mixed_precision, got.gradient_accumulation_steps, got.num_processes) == \
        ("bf16", 4, 2)
    legacy = tmp_path / "hf.yaml"
    legacy.write_text(yaml.safe_dump({"num_machines": 1, "num_processes": 8, "mixed_precision":
                                      "fp16", "main_process_ip": "10.0.0.3",
                                      "main_process_port": 1234}))
    got = LaunchConfig.from_yaml(legacy)
    assert (got.num_processes, got.mixed_precision, got.coordinator_address) == \
        (1, "fp16", "10.0.0.3:1234")
    assert LaunchConfig.from_yaml(tmp_path / "absent.yaml") == LaunchConfig()


NCCL_SCRIPT = """
import torch
from accelerate_tpu_torch.accelerator import Accelerator
acc = Accelerator()
assert acc.num_processes == 1 and acc.state.partial.backend == "nccl", acc
assert acc.device == torch.device("cuda", 0)
model = torch.nn.Linear(8, 8, device="cuda")
model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
step = acc.make_train_step(lambda m, b: (m(b) ** 2).mean())
losses = [step(torch.ones(4, 8, device="cuda")).item() for _ in range(3)]
assert losses[-1] < losses[0], losses
print("nccl world 1 ok", losses)
"""


@pytest.mark.cuda
def test_one_nccl_rank_through_the_launcher(tmp_path):
    from accelerate_tpu_torch.utils.environment import on_hopper

    if not on_hopper():
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0)")
    script = tmp_path / "nccl.py"
    script.write_text(NCCL_SCRIPT)
    out = _run(["--num_processes", "1", str(script)])
    assert out.returncode == 0, out.stderr
    assert "nccl world 1 ok" in out.stdout


def test_cli_config_writes_a_file_the_launcher_reads(tmp_path):
    from accelerate_tpu_torch.commands import cli

    path = tmp_path / "config.yaml"
    assert cli.main(["config", "--default", "--mixed_precision", "bf16",
                     "--config_file", str(path)]) == 0
    assert LaunchConfig.from_yaml(path).mixed_precision == "bf16"
    assert cli.main(["config-update", "--config_file", str(path)]) == 0
    out = _run(["--config_file", str(path), "--num_processes", "2", "--dry_run", "train.py"])
    assert out.returncode == 0, out.stderr
    assert all("ACCELERATE_TPU_MIXED_PRECISION=bf16" in line.split()
               for line in out.stdout.strip().splitlines())
