"""The launch configuration file: the port of `accelerate_tpu.commands.config`.

`LaunchConfig` keeps the reference's YAML format field for field, so a file
the reference's ``config`` command wrote loads here, older and Hugging Face
style keys included (``num_machines``, ``machine_rank``,
``main_process_ip``/``main_process_port``, ``distributed_type``). In the port
``num_processes`` counts processes (one a device) on this machine. The
precedence is the reference's: a launch flag, then an ``ACCELERATE_TPU_*``
variable, then the file. PyYAML is imported only to read or write a file.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import asdict, dataclass
from pathlib import Path

from ..utils.constants import DEFAULT_CONFIG_DIR_ENV, DEFAULT_CONFIG_NAME

CONFIG_VERSION = 1

# older and Hugging Face config keys, renamed on read
_LEGACY_KEYS = {
    "num_machines": "num_processes",
    "machine_rank": "process_id",
    "debug_mode": "debug",
}


def default_config_file() -> Path:
    """``$ACCELERATE_TPU_CONFIG_DIR/default_config.yaml``, else under
    ``~/.cache/accelerate_tpu``."""
    base = os.environ.get(DEFAULT_CONFIG_DIR_ENV)
    if base is None:
        base = os.path.join(os.path.expanduser("~"), ".cache", "accelerate_tpu")
    return Path(base) / DEFAULT_CONFIG_NAME


def _migrate_legacy(data: dict) -> dict:
    """An older or Hugging Face style config in the current keys (reference
    `commands/config.py:40`)."""
    out = dict(data)
    if "num_machines" in out:
        out.pop("num_processes", None)
    for old, new in _LEGACY_KEYS.items():
        if old in out and new not in out:
            out[new] = out.pop(old)
    ip, port = out.pop("main_process_ip", None), out.pop("main_process_port", None)
    if ip and "coordinator_address" not in out:
        out["coordinator_address"] = f"{ip}:{port or 29500}"
    dist = str(out.pop("distributed_type", "")).upper()
    if dist == "FSDP" and "fsdp_size" not in out:
        out["fsdp_size"] = -1
        out.setdefault("data_parallel_size", 1)
    if dist == "MEGATRON_LM":
        mega = out.pop("megatron_lm_config", {}) or {}
        out.setdefault("tensor_size", int(mega.get("megatron_lm_tp_degree", 1)))
        out.setdefault("stage_size", int(mega.get("megatron_lm_pp_degree", 1)))
    if str(out.get("mixed_precision", "")).lower() in ("", "none"):
        out["mixed_precision"] = "no"
    return out


@dataclass
class LaunchConfig:
    """What the launcher needs to start a run (the reference's fields)."""

    compute_environment: str = "LOCAL_MACHINE"
    num_processes: int = 1
    process_id: int = 0
    coordinator_address: str | None = None
    mixed_precision: str = "no"
    data_parallel_size: int = -1
    fsdp_size: int = 1
    tensor_size: int = 1
    sequence_size: int = 1
    stage_size: int = 1
    gradient_accumulation_steps: int = 1
    debug: bool = False
    sagemaker: dict | None = None

    def to_yaml(self, path: Path | None = None) -> Path:
        import yaml

        path = Path(path) if path is not None else default_config_file()
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump({"config_version": CONFIG_VERSION, **asdict(self)}, f, sort_keys=False)
        return path

    @classmethod
    def from_yaml(cls, path: Path | None = None) -> "LaunchConfig":
        """The file at ``path`` (default `default_config_file`), or the
        defaults when there is none."""
        path = Path(path) if path is not None else default_config_file()
        if not path.exists():
            return cls()
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        if data.get("config_version", 0) < CONFIG_VERSION:
            data = _migrate_legacy(data)
        return cls(**{k: v for k, v in data.items() if k in cls.__dataclass_fields__})


def write_basic_config(mixed_precision: str = "no", save_location: str | None = None) -> Path:
    """The default config written in one call (reference
    `write_basic_config`)."""
    cfg = LaunchConfig(mixed_precision=mixed_precision)
    return cfg.to_yaml(Path(save_location) if save_location else None)


def _ask(prompt: str, default: str, choices: list[str] | None = None) -> str:
    hint = f" [{'/'.join(choices)}]" if choices else ""
    while True:
        raw = input(f"{prompt}{hint} ({default}): ").strip() or default
        if not choices or raw in choices:
            return raw
        print(f"choose one of {choices}")


def config_command(args: argparse.Namespace) -> None:
    if getattr(args, "default", False):
        path = write_basic_config(getattr(args, "mixed_precision", "no"), args.config_file)
        print(f"Wrote default config to {path}")
        return
    cfg = LaunchConfig()
    cfg.num_processes = int(_ask("Processes (one a GPU) on this machine", "1"))
    cfg.mixed_precision = _ask("Mixed precision", "bf16", ["no", "bf16", "fp16", "fp8"])
    cfg.gradient_accumulation_steps = int(_ask("Gradient accumulation steps", "1"))
    path = cfg.to_yaml(Path(args.config_file) if args.config_file else None)
    print(f"Configuration saved to {path}")


def update_command(args: argparse.Namespace) -> None:
    """Rewrite an old (or Hugging Face) config in the current keys."""
    src = Path(args.config_file) if args.config_file else default_config_file()
    path = LaunchConfig.from_yaml(src).to_yaml(src)
    print(f"Rewrote {path} at config_version={CONFIG_VERSION}")


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("config", help="create the launch configuration")
    p.add_argument("--config_file", default=None, help="where to save the YAML")
    p.add_argument("--default", action="store_true", help="write defaults without asking")
    p.add_argument("--mixed_precision", default="no")
    p.set_defaults(func=config_command)
    u = subparsers.add_parser("config-update", help="migrate a config file to the current keys")
    u.add_argument("--config_file", default=None)
    u.set_defaults(func=update_command)
