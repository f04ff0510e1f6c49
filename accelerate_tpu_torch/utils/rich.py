"""Rich tracebacks: the port of `accelerate_tpu.utils.rich`. Importing this
module installs `rich`'s traceback handler; without `rich` it raises
ModuleNotFoundError, as the reference's does. The package root imports it
only when `utils.imports.is_rich_available` says `rich` is installed."""

from .imports import is_rich_available

if is_rich_available():
    from rich.traceback import install

    install(show_locals=False)
else:
    raise ModuleNotFoundError("To use the rich extension, install rich with `pip install rich`")
