"""Version comparison gates: the port of `accelerate_tpu.utils.versions`
(the reference's `utils/versions.py`), with `is_torch_version` for its
``is_jax_version``."""

from __future__ import annotations

import importlib.metadata
import operator

_OPS = {
    "<": operator.lt, "<=": operator.le, "==": operator.eq,
    "!=": operator.ne, ">=": operator.ge, ">": operator.gt,
}


def _parse(v: str) -> tuple:
    """Numeric components from leading digits, padded, and a final marker
    that ranks pre-releases ("2.4.0rc1") below their release ("2.4.0"). A PEP
    440 local segment ("2.11.0+cu128") is dropped first: a local build meets
    the bounds of its public release and is no pre-release."""
    v = v.split("+", 1)[0]
    parts = []
    prerelease = False
    for p in v.split("."):
        i = 0
        while i < len(p) and p[i].isdigit():
            i += 1
        parts.append(int(p[:i]) if i else 0)
        if i < len(p):
            prerelease = True
    while len(parts) < 4:
        parts.append(0)
    parts.append(0 if prerelease else 1)
    return tuple(parts)


def compare_versions(library_or_version: str, operation: str, requirement_version: str) -> bool:
    """``compare_versions("torch", ">=", "2.4")`` or
    ``compare_versions("2.11.0", "<", "3")``: a name that is no installed
    package is read as a version."""
    if operation not in _OPS:
        raise ValueError(f"operation must be one of {sorted(_OPS)}, got {operation}")
    try:
        version = importlib.metadata.version(library_or_version)
    except importlib.metadata.PackageNotFoundError:
        version = library_or_version
    return _OPS[operation](_parse(version), _parse(requirement_version))


def is_torch_version(operation: str, version: str) -> bool:
    return compare_versions("torch", operation, version)
