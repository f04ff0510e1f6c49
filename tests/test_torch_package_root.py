"""The port's package root against the reference's: every name that
`accelerate_tpu/__init__.py` exports is exported by `accelerate_tpu_torch`
(`__all__`) or deferred, with its ROADMAP item, in `DEFERRED_ROOT_NAMES`;
every ``from accelerate_tpu import X`` of the repository's examples and docs
resolves against the port; and a cold ``import accelerate_tpu_torch`` stays
lazy (no `torch`, no kernel build, no `rich`)."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import accelerate_tpu_torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _reference_root_names() -> set[str]:
    names = set()
    for node in ast.walk(ast.parse((ROOT / "accelerate_tpu" / "__init__.py").read_text())):
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


def _imports_from_reference_root(text: str) -> set[str]:
    """Names of every ``from accelerate_tpu import ...`` statement in ``text``
    (a source file or the code blocks of a markdown page)."""
    names = set()
    for m in re.finditer(r"^\s*from accelerate_tpu import (\([^)]*\)|[^\n]*)", text, re.M):
        body = m.group(1).strip("()")
        body = re.sub(r"#[^\n]*", "", body)
        for part in body.replace("\n", ",").split(","):
            part = part.strip().split(" as ")[0].strip()
            if part and part != "\\":
                names.add(part)
    return names


DEFERRED = dict(accelerate_tpu_torch.DEFERRED_ROOT_NAMES)


def test_root_names_are_the_reference_s_ported_or_deferred():
    ref = _reference_root_names()
    assert len(ref) == 104
    assert set(accelerate_tpu_torch.__all__) | set(DEFERRED) == ref
    assert not set(accelerate_tpu_torch.__all__) & set(DEFERRED)
    assert len(accelerate_tpu_torch.DEFERRED_ROOT_NAMES) == len(DEFERRED) == 9
    assert all("item 21.3" in why for why in DEFERRED.values())


@pytest.mark.parametrize("name", sorted(DEFERRED))
def test_deferred_names_raise_with_their_item(name):
    with pytest.raises(AttributeError, match="21.3"):
        getattr(accelerate_tpu_torch, name)


def test_every_exported_name_resolves():
    for name in accelerate_tpu_torch.__all__:
        assert getattr(accelerate_tpu_torch, name) is not None, name


def test_examples_and_docs_import_against_the_port():
    files = sorted([*(ROOT / "examples").rglob("*.py"), *(ROOT / "docs").rglob("*.md"),
                    *(ROOT / "examples").rglob("*.md")])
    used = {}
    for f in files:
        for name in _imports_from_reference_root(f.read_text()):
            used.setdefault(name, f.relative_to(ROOT))
    assert len(used) >= 15
    for name, where in used.items():
        if name in DEFERRED:
            continue
        ns = {}
        exec(f"from accelerate_tpu_torch import {name}", ns)  # noqa: S102
        assert ns[name] is not None, (name, where)


def test_fp8_dense_is_the_port_s_fp8_linear():
    from accelerate_tpu_torch import Fp8Dense
    from accelerate_tpu_torch.ops.fp8 import Fp8Linear

    assert Fp8Dense is Fp8Linear


def test_names_are_the_defining_modules_objects():
    from accelerate_tpu_torch import Accelerator, ServingEngine, convert_outputs_to_fp32, get_sampler
    from accelerate_tpu_torch.accelerator import Accelerator as A
    from accelerate_tpu_torch.data_loader import get_sampler as gs
    from accelerate_tpu_torch.serving.engine import ServingEngine as S
    from accelerate_tpu_torch.utils.operations import convert_outputs_to_fp32 as c

    assert (Accelerator, ServingEngine, get_sampler, convert_outputs_to_fp32) == (A, S, gs, c)


def test_rich_is_exported_as_the_reference_s_root_does(monkeypatch):
    from accelerate_tpu_torch.utils.imports import is_rich_available

    monkeypatch.setattr(sys, "excepthook", sys.excepthook)  # rich installs its own
    assert ("rich" in accelerate_tpu_torch.__all__) == is_rich_available()
    if is_rich_available():
        from accelerate_tpu_torch import rich

        assert rich.__name__ == "accelerate_tpu_torch.utils.rich"
        assert sys.excepthook.__module__.startswith("rich")


def test_rich_without_the_package_raises_as_the_reference_s(monkeypatch):
    import importlib

    from accelerate_tpu_torch.utils import imports

    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.setattr(imports, "is_rich_available", lambda: False)
    monkeypatch.delitem(sys.modules, "accelerate_tpu_torch.utils.rich", raising=False)
    with pytest.raises(ModuleNotFoundError, match="pip install rich"):
        importlib.import_module("accelerate_tpu_torch.utils.rich")
    with pytest.raises(AttributeError):  # the root resolves rich only when it is installed
        getattr(accelerate_tpu_torch, "rich")


COLD = """
import json, sys, time
t0 = time.perf_counter()
import accelerate_tpu_torch
seconds = time.perf_counter() - t0
loaded = sorted({m.split(".")[0] for m in sys.modules})
port = sorted(m for m in sys.modules if m.startswith("accelerate_tpu_torch."))
print(json.dumps({"seconds": seconds, "loaded": loaded, "port": port,
                  "n_all": len(accelerate_tpu_torch.__all__)}))
"""


def test_cold_import_stays_lazy():
    out = subprocess.run([sys.executable, "-c", COLD], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for heavy in ("torch", "numpy", "rich", "jax", "accelerate_tpu", "triton"):
        assert heavy not in got["loaded"], heavy
    # only the availability probe the rich rule needs
    assert got["port"] == ["accelerate_tpu_torch.utils", "accelerate_tpu_torch.utils.imports"]
    assert got["n_all"] == 95
    assert got["seconds"] < 1.0
