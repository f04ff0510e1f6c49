"""The one-machine surface on the card.

- the serving example with the paged fused engine (kernel #1,
  `paged_decode_attention`) against the example's default slot engine on
  one tiny fp32 GPT-2 (TF32 off): equal greedy streams, and the kernel ran
  ``n_layer`` times per decode forward, counted through the replays;
- ``cli test`` at one NCCL rank through the launcher: exit 0 and the
  success line.

Every test needs an NVIDIA Hopper GPU and skips elsewhere. The file imports
nothing of JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_one_machine.py
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def card():
    from accelerate_tpu_torch.utils.environment import on_hopper

    if not on_hopper():
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_serving_example_fused_engine_matches_the_default_engine(card, tmp_path):
    from accelerate_tpu_torch.examples import serving_gpt2
    from accelerate_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config.tiny(dtype=torch.float32, n_embd=128, n_head=2)
    plain = serving_gpt2.main(cfg, device=card, logging_dir=str(tmp_path / "slot"), quiet=True)
    fused = serving_gpt2.main(cfg, device=card, logging_dir=str(tmp_path / "fused"), quiet=True,
                              paged_kv=True, paged_attention="fused")
    greedy = [i for i, (_, s) in enumerate(serving_gpt2.REQUESTS) if "temperature" not in s]
    for i in greedy:
        assert plain["outputs"][i].tokens == fused["outputs"][i].tokens, i
    # what one decode replay launches, counted by the wrapper at the capture
    engine = fused["engine"]
    assert engine.graph_launches["paged_decode_attention"] == cfg.n_layer * engine.tokens_per_sync
    assert engine.metrics.decode_dispatches.value > 0
    assert plain["engine"].graph_launches.get("paged_decode_attention", 0) == 0


def test_cli_test_at_one_nccl_rank(card, tmp_path):
    from accelerate_tpu_torch.commands.launch import scrubbed_environ
    from accelerate_tpu_torch.commands.test import SUCCESS

    out = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.launch", "--num_processes", "1",
         "-m", "accelerate_tpu_torch.commands.cli", "test",
         "--config_file", str(tmp_path / "none.yaml")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**scrubbed_environ(), "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "cuda:0, 1 process(es)" in out.stdout
    assert out.stdout.rstrip().endswith(SUCCESS)
