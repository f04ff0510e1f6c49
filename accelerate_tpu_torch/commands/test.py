"""``test``: the install check, the port of `accelerate_tpu.commands.test`.
It puts the launch configuration's variables in the environment
(`config.LaunchConfig.from_yaml`, `launch.launch_env`; under the launcher
the launcher's own win) and runs `test_utils.test_script` in this process,
on the launcher's topology: ``python -m accelerate_tpu_torch.commands.launch
--num_processes N -m accelerate_tpu_torch.commands.cli test`` runs it on N
ranks. ``--device cpu`` asks for the CPU; two ranks sharing one card over
gloo pass ``--device cuda:0``."""

from __future__ import annotations

import argparse
import os
from pathlib import Path

SUCCESS = "Test is a success! You are ready for your distributed training!"


def test_command(args: argparse.Namespace) -> None:
    from ..test_utils import test_script
    from .config import LaunchConfig
    from .launch import launch_env

    cfg = LaunchConfig.from_yaml(Path(args.config_file) if args.config_file else None)
    for key, value in launch_env(cfg).items():
        os.environ.setdefault(key, value)
    test_script.main(device=args.device)
    print(SUCCESS)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("test", help="run the bundled end-to-end sanity script")
    p.add_argument("--config_file", default=None, help="the launch configuration to test")
    p.add_argument("--device", default=None,
                   help="default: the launcher's (CUDA, or the CPU under --debug_cpu); 'cpu' "
                        "for the plain path")
    p.set_defaults(func=test_command)
