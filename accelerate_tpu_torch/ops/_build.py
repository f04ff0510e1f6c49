"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` exposes a plain C interface. It is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library at first use and loaded
through `ctypes`: no PyTorch headers are compiled, so a build takes seconds.
Pointers cross as ``c_void_p`` and the launch stream as
``torch.cuda.current_stream().cuda_stream``; every entry point returns the
CUDA error code of its launch for the wrapper to check.

The library lands in ``ops/build/`` (listed in ``.gitignore``) under a name
that carries a hash of the source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header is never served by a stale build. A
failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, into the build log
)

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``
    (``/usr/local/cuda`` by default)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA kernels "
        "are compiled at first use and need the CUDA toolkit"
    )


def _artifact(name: str) -> tuple[Path, Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # what a source may include
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{tag}.so", BUILD_DIR / f"{name}-{tag}.log"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists;
    returns the shared library's path."""
    src, lib, log = _artifact(name)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    log.write_text(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode} building {src}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` ('' before a build)."""
    log = _artifact(name)[2]
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed. A
    library stays loaded for the life of the process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
