"""The PyTorch port stands alone: importing every module of
`accelerate_tpu_torch` brings in neither JAX nor the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, json, pkgutil, sys
import accelerate_tpu_torch
light = sorted(m.split(".")[0] for m in sys.modules
               if m.split(".")[0] in ("torch", "numpy"))
names = ["accelerate_tpu_torch"]
for info in pkgutil.walk_packages(accelerate_tpu_torch.__path__, "accelerate_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "accelerate_tpu"))
print(json.dumps({"modules": names, "banned": banned, "light": light}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["banned"] == []
    # the package root imports nothing heavy eagerly
    assert got["light"] == []
    for mod in ("accelerate_tpu_torch.serving.engine", "accelerate_tpu_torch.models.gpt2",
                "accelerate_tpu_torch.ops.flash_attention", "accelerate_tpu_torch.ops._build",
                "accelerate_tpu_torch.ops.fused_ce", "accelerate_tpu_torch.models.llama",
                "accelerate_tpu_torch.accelerator", "accelerate_tpu_torch.state",
                "accelerate_tpu_torch.optimizer", "accelerate_tpu_torch.utils.precision"):
        assert mod in got["modules"]
