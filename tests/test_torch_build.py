"""`ops/_build.py`'s library names: a build is keyed by its source, the
shared headers ``csrc/*.cuh`` it may include and nvcc's flags, so an edited
header is never served by a stale library. Runs on the CPU (no nvcc)."""

import shutil

import pytest

from accelerate_tpu_torch.ops import _build


@pytest.fixture
def csrc(monkeypatch, tmp_path):
    """A copy of the fused-CE source and the shared header, as ``CSRC_DIR``."""
    for name in ("fused_ce.cu", "sm90.cuh"):
        shutil.copy(_build.CSRC_DIR / name, tmp_path / name)
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    return tmp_path


def _library(name: str) -> str:
    return _build._artifact(name)[1].name


def test_editing_a_shared_header_renames_the_library(csrc):
    before = _library("fused_ce")
    assert before.startswith("libfused_ce-") and before.endswith(".so")
    with open(csrc / "sm90.cuh", "a") as f:
        f.write("\n// one more line\n")
    assert _library("fused_ce") != before


@pytest.mark.parametrize("change,renames", [
    ("new_header", True),   # a source may include any csrc/*.cuh
    ("other_file", False),  # what is neither the source nor a header does not count
    ("source", True),
])
def test_library_name_follows_source_and_headers_only(csrc, change, renames):
    before = _library("fused_ce")
    if change == "new_header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    elif change == "other_file":
        (csrc / "notes.txt").write_text("not compiled\n")
    else:
        with open(csrc / "fused_ce.cu", "a") as f:
            f.write("\n// one more line\n")
    assert (_library("fused_ce") != before) == renames
