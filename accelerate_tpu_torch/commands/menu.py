"""Arrow-key selection menu behind ``config``'s questionnaire: the port of
`accelerate_tpu.commands.menu`, kept whole (it is plain Python). One class,
raw-terminal key decoding inline, and an injectable key reader so tests
script keystrokes without a pty. Without a TTY on stdin it asks for a
number instead.
"""

from __future__ import annotations

import sys
from typing import Callable, Sequence

# decoded key events produced by _read_key
UP, DOWN, ENTER, INTERRUPT = "up", "down", "enter", "interrupt"


def _read_key(stream=None) -> str:
    """Block for one keypress on the controlling terminal and decode it to a
    key event or a literal character. Raw mode spans exactly one key so ^C
    remains deliverable between keys. Bytes come via ``os.read`` on the fd —
    a buffered ``stream.read(1)`` would slurp the whole ESC sequence into the
    TextIOWrapper buffer, the select() poll would then miss the tail, and
    arrow navigation would silently die."""
    import os
    import select
    import termios
    import tty

    stream = stream or sys.stdin
    fd = stream.fileno()
    saved = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        ch = os.read(fd, 1).decode(errors="replace")
        if ch == "\x1b":  # escape sequence: arrows are ESC [ A/B
            # a bare Esc press has no tail — poll so it doesn't block the menu
            # (and later keystrokes aren't eaten as a phantom escape tail)
            tail = b""
            while len(tail) < 2 and select.select([fd], [], [], 0.05)[0]:
                tail += os.read(fd, 1)
            if tail in (b"[A", b"OA"):
                return UP
            if tail in (b"[B", b"OB"):
                return DOWN
            return ""
        if ch in ("\r", "\n"):
            return ENTER
        if ch == "\x03":
            return INTERRUPT
        return ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, saved)


class SelectionMenu:
    """Interactive single-choice menu.

    Keys: ↑/↓ (also k/j) move, digits jump, Enter selects, ^C raises
    KeyboardInterrupt. ``run()`` returns the selected *index*.
    """

    def __init__(
        self,
        prompt: str,
        choices: Sequence[str],
        default_index: int = 0,
        key_reader: Callable[[], str] | None = None,
        out=None,
    ):
        if not choices:
            raise ValueError("SelectionMenu needs at least one choice")
        self.prompt = prompt
        self.choices = list(choices)
        self.index = min(max(default_index, 0), len(choices) - 1)
        self._read = key_reader or _read_key
        self._out = out or sys.stdout

    # one menu line, highlighted when selected
    def _line(self, i: int) -> str:
        marker = "●" if i == self.index else " "
        text = f" {marker} {i}. {self.choices[i]}"
        return f"\x1b[7m{text}\x1b[0m" if i == self.index else text

    def _render(self, first: bool) -> None:
        w = self._out
        if not first:
            w.write(f"\x1b[{len(self.choices)}A")  # cursor up to re-render in place
        for i in range(len(self.choices)):
            w.write("\x1b[2K" + self._line(i) + "\n")
        w.flush()

    def step(self, key: str) -> bool:
        """Apply one key event; True when the selection is finalized."""
        if key == ENTER:
            return True
        if key == INTERRUPT:
            raise KeyboardInterrupt
        if key in (UP, "k"):
            self.index = (self.index - 1) % len(self.choices)
        elif key in (DOWN, "j"):
            self.index = (self.index + 1) % len(self.choices)
        elif key.isdigit() and int(key) < len(self.choices):
            self.index = int(key)
        return False

    def run(self) -> int:
        self._out.write(self.prompt + " (arrows + Enter):\n")
        self._render(first=True)
        while True:
            done = self.step(self._read())
            if done:
                return self.index
            self._render(first=False)


def choose(
    prompt: str,
    choices: Sequence[str],
    default: str,
    key_reader: Callable[[], str] | None = None,
) -> str:
    """Menu when interactive, numbered-input fallback otherwise; returns the
    chosen *value*. The questionnaire's one entry point."""
    default_index = choices.index(default) if default in choices else 0
    # Probe raw-mode availability up front instead of catching errors around
    # the whole menu run — a broad catch there would mask real bugs (e.g. a
    # key_reader raising ValueError) as a silent fallback.
    interactive = key_reader is not None or (
        sys.stdin.isatty() and sys.stdout.isatty() and _raw_mode_works()
    )
    if interactive:
        idx = SelectionMenu(prompt, choices, default_index, key_reader=key_reader).run()
        return choices[idx]
    listing = ", ".join(f"{i}={c}" for i, c in enumerate(choices))
    raw = input(f"{prompt} [{listing}] ({default}): ").strip()
    if raw.isdigit() and int(raw) < len(choices):
        return choices[int(raw)]
    if raw in choices:
        return raw
    if raw:
        print(f"  invalid choice {raw!r}, using {default}")
    return default


def _raw_mode_works() -> bool:
    """True when stdin's terminal actually supports raw mode — not just when
    termios imports. termios.error subclasses Exception (not OSError), and
    ValueError covers fileno() on detached streams."""
    try:
        import termios
        import tty  # noqa: F401
    except ImportError:
        return False
    try:
        termios.tcgetattr(sys.stdin.fileno())
        return True
    except (OSError, ValueError, termios.error):
        return False
