"""Terminal frame displays (reference src/app/aadisp.cpp + display.cpp).

The reference ships two display sinks: an SDL YUV window
(display.cpp:1-785, threadplayer.cpp UniSurface) and an aalib
ASCII-art fallback (aadisp.cpp:7-54). This environment is headless, so
this package's display tier targets the terminal:

* :class:`AnsiDisplay` — truecolor half-block rendering (two pixels per
  character cell via '▀' with independent fg/bg), the SDL-window analog.
* :class:`AsciiDisplay` — luma-ramp ASCII art, the aadisp analog.

Both downsample by integer stride to fit the terminal and convert YUV
with the same BT.601 integer math as the reference's yuv2rgb
(display.cpp), clipped to 0..255.
"""

from __future__ import annotations

import shutil
import sys

import numpy as np

#: aalib-flavored luma ramp, dark -> bright
_RAMP = " .:-=+*#%@"


def _yuv_to_rgb(y, cb, cr):
    """BT.601 full-swing integer conversion (display.cpp yuv2rgb
    semantics): r = y + 1.402 (cr-128) etc., fixed-point, clipped."""
    y = y.astype(np.int32)
    u = cb.astype(np.int32) - 128
    v = cr.astype(np.int32) - 128
    r = y + ((359 * v) >> 8)
    g = y - ((88 * u + 183 * v) >> 8)
    b = y + ((454 * u) >> 8)
    return [np.clip(c, 0, 255).astype(np.uint8) for c in (r, g, b)]


def _sample(frame, max_w, max_h):
    """Crop, then integer-stride downsample to fit (max_w, max_h);
    returns (y, cb, cr) at the sampled luma grid (chroma upsampled 2x
    first)."""
    cl, cr_, ct, cb_ = getattr(frame, "crop", (0, 0, 0, 0))
    h = frame.height - ct - cb_
    w = frame.width - cl - cr_
    y = frame.y[ct : ct + h, cl : cl + w]
    cb = frame.cb[ct >> 1 : (ct + h + 1) >> 1, cl >> 1 : (cl + w + 1) >> 1]
    cr = frame.cr[ct >> 1 : (ct + h + 1) >> 1, cl >> 1 : (cl + w + 1) >> 1]
    cb = cb.repeat(2, 0).repeat(2, 1)[:h, :w]
    cr = cr.repeat(2, 0).repeat(2, 1)[:h, :w]
    step = max(1, (w + max_w - 1) // max_w, (h + max_h - 1) // max_h)
    return (y[::step, ::step], cb[::step, ::step], cr[::step, ::step])


class AnsiDisplay:
    """Truecolor terminal display: one character cell shows two
    vertically-stacked pixels ('▀', fg = top row, bg = bottom row)."""

    def __init__(self, out=None, max_size=None):
        self.out = out if out is not None else sys.stdout
        if max_size is None:
            ts = shutil.get_terminal_size((80, 24))
            max_size = (ts.columns, max(2, (ts.lines - 1) * 2))
        self.max_w, self.max_h = max_size
        self._first = True

    def render(self, frame) -> str:
        y, cb, cr = _sample(frame, self.max_w, self.max_h)
        if y.shape[0] & 1:
            y, cb, cr = (a[:-1] for a in (y, cb, cr))
        r, g, b = _yuv_to_rgb(y, cb, cr)
        top = [c[0::2] for c in (r, g, b)]
        bot = [c[1::2] for c in (r, g, b)]
        rows = []
        for i in range(top[0].shape[0]):
            cells = []
            for j in range(top[0].shape[1]):
                cells.append(
                    f"\x1b[38;2;{top[0][i, j]};{top[1][i, j]};"
                    f"{top[2][i, j]}m\x1b[48;2;{bot[0][i, j]};"
                    f"{bot[1][i, j]};{bot[2][i, j]}m▀")
            rows.append("".join(cells) + "\x1b[0m")
        return "\n".join(rows)

    def show(self, frame):
        text = self.render(frame)
        n_rows = text.count("\n") + 1
        if not self._first:
            self.out.write(f"\x1b[{n_rows}A")  # repaint in place
        self._first = False
        self.out.write(text + "\n")
        self.out.flush()


class AsciiDisplay:
    """aadisp.cpp analog: luma-only ASCII art (terminal-safe anywhere)."""

    def __init__(self, out=None, max_size=None):
        self.out = out if out is not None else sys.stdout
        if max_size is None:
            ts = shutil.get_terminal_size((80, 24))
            max_size = (ts.columns, max(1, ts.lines - 1))
        self.max_w, self.max_h = max_size
        self._first = True

    def render(self, frame) -> str:
        y, _, _ = _sample(frame, self.max_w, self.max_h * 2)
        y = y[::2]  # character cells are ~2x taller than wide
        idx = (y.astype(np.int32) * len(_RAMP)) >> 8
        lut = np.frombuffer(_RAMP.encode(), np.uint8)
        art = lut[np.clip(idx, 0, len(_RAMP) - 1)]
        return "\n".join(bytes(row).decode() for row in art)

    def show(self, frame):
        text = self.render(frame)
        n_rows = text.count("\n") + 1
        if not self._first:
            self.out.write(f"\x1b[{n_rows}A")
        self._first = False
        self.out.write(text + "\n")
        self.out.flush()


def make_display(kind, out=None):
    """Factory for the CLI: kind in ('ansi', 'ascii', 'none')."""
    if kind == "ansi":
        return AnsiDisplay(out=out)
    if kind == "ascii":
        return AsciiDisplay(out=out)
    return None
