"""``python -m accelerate_tpu_torch.commands.cli <command>``: the port's
command root (reference `commands/cli.py`), with ``config``,
``config-update``, ``env``, ``estimate-memory``, ``launch`` and ``test``.
The reference's ``merge-weights`` waits for sharded checkpoints (ROADMAP
Queue 1, item 21.3) and ``tpu-config`` has no counterpart on a GPU machine
(ROADMAP item 41)."""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    from . import config, env, estimate, launch, test

    parser = argparse.ArgumentParser("accelerate_tpu_torch", usage="<command> [<args>]")
    subparsers = parser.add_subparsers(dest="command", required=True)
    for mod in (config, env, launch, test, estimate):
        mod.add_parser(subparsers)
    args = parser.parse_args(argv)
    return args.func(args) or 0


if __name__ == "__main__":
    sys.exit(main())
