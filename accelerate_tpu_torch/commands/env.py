"""``env``: the environment for a bug report, the port of
`accelerate_tpu.commands.env`. The reference's fields, read from PyTorch:
its version, CUDA's and cuDNN's, the devices (name, compute capability,
count), the process count and the config file. The card's power limit comes
from ``nvidia-smi`` when it is on the path, and is left out otherwise; a
machine without a CUDA device says so and reports no card."""

from __future__ import annotations

import argparse
import platform
import shutil
import subprocess


def nvidia_smi_fields() -> dict[str, str]:
    """``name`` and ``power.limit`` of each card as ``nvidia-smi`` reports
    them, or nothing when ``nvidia-smi`` is absent or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {}
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia-smi (name, power limit)": "; ".join(
        line.strip() for line in out.splitlines() if line.strip())}


def environment() -> dict[str, object]:
    import torch

    import accelerate_tpu_torch

    from ..state import topology
    from .config import default_config_file

    info: dict[str, object] = {
        "accelerate_tpu_torch version": accelerate_tpu_torch.__version__,
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "CUDA (torch build)": torch.version.cuda,
        "cuDNN": torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None,
    }
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        info["devices"] = "; ".join(
            f"cuda:{i} {torch.cuda.get_device_name(i)} "
            f"(sm_{''.join(map(str, torch.cuda.get_device_capability(i)))})" for i in range(n))
        info["device count"] = n
        info.update(nvidia_smi_fields())
    else:
        info["devices"] = "no CUDA device"
        info["device count"] = 0
        if shutil.which("nvidia-smi") is None:
            info["nvidia-smi"] = "not found"
    info["process_count"] = topology().num_processes
    info["config file"] = str(default_config_file())
    return info


def env_command(args: argparse.Namespace) -> None:
    print("\n".join(f"- {k}: {v}" for k, v in environment().items()))


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("env", help="print environment info")
    p.set_defaults(func=env_command)
