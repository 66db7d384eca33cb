"""Terminal live view: ANSI truecolor rendering of radiance images.

The reference's realtime mode is a vsynced GL window redrawn every frame
(``src/main.c:250-286``). On a headless GPU host there is
no display; the analog is the terminal itself: each u8 frame
is drawn as 24-bit-color half-block characters (▀ carries two vertical
pixels per character cell), and successive frames rewrite in place with
cursor-up escapes — a live, progressively-refining view for
``render --progressive --live`` and a realtime sweep for
``animate --live``.

Pure string generation (testable without a TTY); the writer only needs a
stream that accepts ANSI escapes.
"""

from __future__ import annotations

import sys

__all__ = ["frame_to_ansi", "TerminalViewer"]

_HALF = "▀"  # upper half block: fg = top pixel, bg = bottom pixel


def _downsample(img, max_w: int, max_h: int):
    """Nearest-neighbor fit of (H, W, 3) u8 into the character budget
    (max_h character rows show 2*max_h pixel rows)."""
    import numpy as np

    h, w = img.shape[:2]
    step = max(1, (w + max_w - 1) // max_w, (h + 2 * max_h - 1) // (2 * max_h))
    out = img[::step, ::step]
    if out.shape[0] % 2:  # half-block rows consume pixel pairs
        out = np.concatenate([out, out[-1:]], axis=0)
    return out


def frame_to_ansi(img, max_w: int = 100, max_h: int = 28) -> str:
    """(H, W, 3) uint8 image -> ANSI truecolor half-block string."""
    img = _downsample(img, max_w, max_h)
    rows = []
    for y in range(0, img.shape[0], 2):
        top = img[y]
        bot = img[y + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m"
            + _HALF
            for t, b in zip(top, bot)
        ]
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


class TerminalViewer:
    """Redraws frames in place (cursor-up rewrite), like a window."""

    def __init__(self, stream=None, max_w: int = 100, max_h: int = 28):
        self.stream = stream if stream is not None else sys.stdout
        self.max_w = max_w
        self.max_h = max_h
        self._last_lines = 0

    def show(self, img, caption: str = ""):
        text = frame_to_ansi(img, self.max_w, self.max_h)
        if caption:
            text = text + "\n" + caption
        n = text.count("\n") + 1
        if self._last_lines:
            self.stream.write(f"\x1b[{self._last_lines}F\x1b[0J")
        self.stream.write(text + "\n")
        self.stream.flush()
        self._last_lines = n
