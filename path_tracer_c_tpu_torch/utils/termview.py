"""Terminal live view: uint8 frames drawn as ANSI truecolor text.

The reference's realtime mode redraws a window every frame. A headless
host has none, so the terminal takes its place: each pixel pair of a
column becomes one upper-half-block character, the top pixel its
foreground colour and the bottom one its background, and every frame
rewrites the last in place. ``render --live`` shows the accumulating
image after every chunk, ``animate --live`` each frame of the sweep.
Pure string generation (``frame_to_ansi``), so it is testable without a
terminal.
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["frame_to_ansi", "TerminalViewer"]

_HALF = "▀"  # upper half block: foreground = top pixel, background = bottom


def _downsample(img, max_w: int, max_h: int) -> np.ndarray:
    """Nearest-neighbour fit of an (H, W, 3) image into ``max_w`` columns
    and ``max_h`` character rows (``2 * max_h`` pixel rows), with an even
    number of rows."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    step = max(1, (w + max_w - 1) // max_w, (h + 2 * max_h - 1) // (2 * max_h))
    out = img[::step, ::step]
    if out.shape[0] % 2:
        out = np.concatenate([out, out[-1:]], axis=0)
    return out


def frame_to_ansi(img, max_w: int = 100, max_h: int = 28) -> str:
    """(H, W, 3) uint8 image -> ANSI truecolor half-block text, one line per
    two pixel rows, each line ending in a colour reset."""
    img = _downsample(img, max_w, max_h)
    rows = []
    for y in range(0, img.shape[0], 2):
        cells = [f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m" + _HALF
                 for t, b in zip(img[y], img[y + 1])]
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


class TerminalViewer:
    """Redraws frames in place (cursor up, clear to the end), like a window."""

    def __init__(self, stream=None, max_w: int = 100, max_h: int = 28):
        self.stream = stream if stream is not None else sys.stdout
        self.max_w = max_w
        self.max_h = max_h
        self._last_lines = 0

    def show(self, img, caption: str = "") -> None:
        text = frame_to_ansi(img, self.max_w, self.max_h)
        if caption:
            text = text + "\n" + caption
        if self._last_lines:
            self.stream.write(f"\x1b[{self._last_lines}F\x1b[0J")
        self.stream.write(text + "\n")
        self.stream.flush()
        self._last_lines = text.count("\n") + 1
