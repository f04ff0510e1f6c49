"""``python -m accelerate_tpu_torch.commands.cli <command>``: the port's
command root (reference `commands/cli.py`), with ``launch``, ``config`` and
``config-update``."""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    from . import config, launch

    parser = argparse.ArgumentParser("accelerate_tpu_torch", usage="<command> [<args>]")
    subparsers = parser.add_subparsers(dest="command", required=True)
    for mod in (config, launch):
        mod.add_parser(subparsers)
    args = parser.parse_args(argv)
    return args.func(args) or 0


if __name__ == "__main__":
    sys.exit(main())
