"""The PyTorch port stands alone: importing every module of
`accelerate_tpu_torch` brings in neither JAX nor the JAX package, and
`chip_smoke.py` and `flash_ab.py` import neither anywhere in their source."""

import ast
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
                "accelerate_tpu_torch.optimizer", "accelerate_tpu_torch.utils.precision",
                "accelerate_tpu_torch.utils.quantization", "accelerate_tpu_torch.ops.nf4_matmul",
                "accelerate_tpu_torch.utils.safetensors_io", "accelerate_tpu_torch.checkpointing",
                "accelerate_tpu_torch.models.generation", "accelerate_tpu_torch.models.kv_cache",
                "accelerate_tpu_torch.serving.journal", "accelerate_tpu_torch.reliability",
                "accelerate_tpu_torch.reliability.faults",
                "accelerate_tpu_torch.reliability.preemption",
                "accelerate_tpu_torch.reliability.retry", "accelerate_tpu_torch.serving.trace",
                "accelerate_tpu_torch.serving.supervisor", "accelerate_tpu_torch.serving.telemetry",
                "accelerate_tpu_torch.serving.anomaly", "accelerate_tpu_torch.data_loader",
                "accelerate_tpu_torch.scheduler", "accelerate_tpu_torch.tracking",
                "accelerate_tpu_torch.utils.random", "accelerate_tpu_torch.utils.operations",
                "accelerate_tpu_torch.models.bert", "accelerate_tpu_torch.examples.nlp_example",
                "accelerate_tpu_torch.models.resnet", "accelerate_tpu_torch.examples.cv_example",
                "accelerate_tpu_torch.examples.complete_cv_example",
                "accelerate_tpu_torch.examples.complete_nlp_example",
                "accelerate_tpu_torch.memory", "accelerate_tpu_torch.logging",
                "accelerate_tpu_torch.utils.dataclasses", "accelerate_tpu_torch.utils.other",
                "accelerate_tpu_torch.utils.environment", "accelerate_tpu_torch.ops.fp8",
                "accelerate_tpu_torch.utils.remat", "accelerate_tpu_torch.utils.modeling",
                "accelerate_tpu_torch.utils.intermediates",
                "accelerate_tpu_torch.utils.offload", "accelerate_tpu_torch.hooks",
                "accelerate_tpu_torch.big_modeling", "accelerate_tpu_torch.ops.moe",
                "accelerate_tpu_torch.models.mixtral", "accelerate_tpu_torch.models.t5",
                "accelerate_tpu_torch.models.vit", "accelerate_tpu_torch.utils.constants",
                "accelerate_tpu_torch.utils.imports", "accelerate_tpu_torch.utils.versions",
                "accelerate_tpu_torch.utils.tqdm",
                "accelerate_tpu_torch.examples.inference.distributed.image_classification",
                "accelerate_tpu_torch.examples.inference.distributed.batch_text_generation",
                *(f"accelerate_tpu_torch.examples.by_feature.{name}" for name in (
                    "_common", "gradient_accumulation", "checkpointing",
                    "automatic_gradient_accumulation", "early_stopping", "memory", "profiler",
                    "tracking", "cross_validation", "sliding_window_long_context",
                    "schedule_free", "multi_process_metrics", "local_sgd", "ddp_comm_hook")),
                "accelerate_tpu_torch.parallel", "accelerate_tpu_torch.parallel.mesh",
                "accelerate_tpu_torch.parallel.compression", "accelerate_tpu_torch.commands",
                "accelerate_tpu_torch.commands.config", "accelerate_tpu_torch.commands.launch",
                "accelerate_tpu_torch.commands.cli", "accelerate_tpu_torch.launchers",
                "accelerate_tpu_torch.local_sgd", "accelerate_tpu_torch.utils.rich",
                "accelerate_tpu_torch.examples.serving_gpt2",
                "accelerate_tpu_torch.examples.config_yaml_templates",
                "accelerate_tpu_torch.examples.config_yaml_templates.run_me",
                "accelerate_tpu_torch.commands.env", "accelerate_tpu_torch.commands.estimate",
                "accelerate_tpu_torch.commands.menu", "accelerate_tpu_torch.commands.test",
                "accelerate_tpu_torch.test_utils", "accelerate_tpu_torch.test_utils.test_script",
                "accelerate_tpu_torch.test_utils.training",
                "accelerate_tpu_torch.test_utils.scripts",
                *(f"accelerate_tpu_torch.test_utils.scripts.{name}" for name in (
                    "test_multiprocess_ops", "test_sync", "test_dispatcher", "test_metrics"))):
        assert mod in got["modules"]


def _import_roots(script: str) -> set[str]:
    """The top-level package of every import in a script's source."""
    roots = set()
    for node in ast.walk(ast.parse((ROOT / script).read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{script} imports by absolute name"
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax_and_no_reference_package():
    roots = _import_roots("chip_smoke.py")
    assert "accelerate_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "accelerate_tpu"}


def test_flash_ab_imports_no_jax_and_no_reference_package():
    roots = _import_roots("flash_ab.py")
    assert "accelerate_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "accelerate_tpu"}


def test_package_root_exports_quantization_names_lazily():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, accelerate_tpu_torch as p; "
         "print('torch' in sys.modules, p.WeightQuantConfig.__module__, "
         "p.quantize_module.__module__)"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.split() == ["False", "accelerate_tpu_torch.serving.engine",
                                  "accelerate_tpu_torch.utils.quantization"]
