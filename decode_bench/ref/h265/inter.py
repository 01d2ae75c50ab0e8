"""H.265 inter prediction: 8-tap luma / 4-tap chroma interpolation plus
the merge candidate machinery (reference h265.cpp:3080-3720).

Luma: full-precision separable FIR — horizontal pass stored raw, vertical
pass over raw intermediates, single rounding at the store ( (v+2048)>>12
one-dir, v>>6 into the int16 bidir buffer, (b0+b1+64)>>7 on writeback ).
Coordinates clamp per-sample to the picture (address_umv semantics, so
unrestricted vectors read edge-replicated pixels).

Chroma: the reference computes both channels in packed uint64 lanes with
a borrow-prevention bias (interp_chroma1hline_base, h265.cpp:3475-3530);
replicated bit-for-bit with masked 64-bit Python arithmetic since the
lane interactions are part of the observable behaviour.
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1


def _window(plane, y0, x0, h, w, ymax, xmax):
    """plane[y0:y0+h, x0:x0+w] with every coordinate clamped to the
    picture, as nested lists of ints: the benchmark's copy reads each
    block's samples once through it instead of one numpy read per tap;
    what is read is unchanged."""
    ys = np.clip(np.arange(y0, y0 + h), 0, ymax - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, xmax - 1)
    return plane[np.ix_(ys, xs)].tolist()


def _clip255(v):
    return 0 if v < 0 else (255 if v > 255 else v)


def _fir1(a):
    return (-a[0] + 4 * a[1] - 10 * a[2] + 58 * a[3] + 17 * a[4]
            - 5 * a[5] + a[6])


def _fir2(a):
    return (4 * ((a[1] + a[6]) + 10 * (a[3] + a[4])) - 11 * (a[2] + a[5])
            - (a[0] + a[7]))


def _fir3(a):
    return (a[0] - 5 * a[1] + 17 * a[2] + 58 * a[3] - 10 * a[4]
            + 4 * a[5] - a[6])


#: per-frac (taps, left-gap) for the 7/8-tap phases
_LUMA_FIR = {1: (_fir1, 7, 3), 2: (_fir2, 8, 3), 3: (_fir3, 7, 2)}


def interp_luma(ref, xpos, ypos, width, height, mvx, mvy, xmax, ymax):
    """Returns (vals, store_shift): full-precision FIR outputs
    [height][width] plus the one-dir store shift (interp_luma,
    h265.cpp:3386-3456)."""
    xpos += mvx >> 2
    ypos += mvy >> 2
    fx = mvx & 3
    fy = mvy & 3

    win = _window(ref, ypos - 3, xpos - 3, height + 8, width + 8, ymax,
                  xmax)

    def pix(y, x):
        return win[y - ypos + 3][x - xpos + 3]

    if fx == 0 and fy == 0:
        vals = [[pix(ypos + y, xpos + x) << 12 for x in range(width)]
                for y in range(height)]
        return vals, 12
    if fy == 0:
        fir, taps, gap = _LUMA_FIR[fx]
        vals = []
        for y in range(height):
            row = []
            for x in range(width):
                a = [pix(ypos + y, xpos + x - gap + k)
                     for k in range(taps)]
                row.append(fir(a))
            vals.append(row)
        return vals, 6
    if fx == 0:
        fir, taps, gap = _LUMA_FIR[fy]
        vals = []
        for y in range(height):
            row = []
            for x in range(width):
                a = [pix(ypos + y - gap + k, xpos + x)
                     for k in range(taps)]
                row.append(fir(a))
            vals.append(row)
        return vals, 6
    firh, tapsh, gaph = _LUMA_FIR[fx]
    firv, tapsv, gapv = _LUMA_FIR[fy]

    hlines = {}

    def hline(y, x):
        v = hlines.get((y, x))
        if v is None:
            v = hlines[y, x] = firh([pix(y, xpos + x - gaph + k)
                                     for k in range(tapsh)])
        return v

    vals = []
    for y in range(height):
        row = []
        for x in range(width):
            a = [hline(ypos + y - gapv + k, x) for k in range(tapsv)]
            row.append(firv(a))
        vals.append(row)
    return vals, 12


_CHROMA_COEF = (
    (0, 64, 0, 0), (2, 58, 10, 2), (4, 54, 16, 2), (6, 46, 28, 4),
    (4, 36, 36, 4), (4, 28, 46, 6), (2, 16, 54, 4), (2, 10, 58, 2),
)


def interp_chroma(cb_plane, cr_plane, xpos, ypos, width, height, mvx,
                  mvy, xmax, ymax):
    """Packed-lane chroma interpolation (interp_chroma,
    h265.cpp:3496-3551): returns (cb_vals, cr_vals) where each value is
    the lane content BEFORE the store shift (cr already bias-stripped).
    width/height are LUMA dimensions."""
    cxpos = (xpos >> 1) + (mvx >> 3)
    cypos = (ypos >> 1) + (mvy >> 3)
    w = width >> 1
    h = height >> 1
    cxmax = xmax >> 1
    cymax = ymax >> 1
    fx = mvx & 7
    fy = mvy & 7
    c0, c1, c2, c3 = _CHROMA_COEF[fx]
    d0, d1, d2, d3 = _CHROMA_COEF[fy]
    bx = cxpos - 1
    by = cypos - 1

    wcb = _window(cb_plane, by, bx, h + 3, w + 3, cymax, cxmax)
    wcr = _window(cr_plane, by, bx, h + 3, w + 3, cymax, cxmax)

    def load(y, x):
        return (wcb[y - by][x - bx] << 32) | wcr[y - by][x - bx]

    def hl(y, x):
        a0 = load(y, bx + x)
        a1 = load(y, bx + x + 1)
        a2 = load(y, bx + x + 2)
        a3 = load(y, bx + x + 3)
        v = ((((c1 * a1 + c2 * a2) | 0x80000000) - (c0 * a0 + c3 * a3))
             & _M64) & ~0xF8000000
        return v

    cb_vals = [[0] * w for _ in range(h)]
    cr_vals = [[0] * w for _ in range(h)]
    for y in range(h):
        for x in range(w):
            h0 = hl(by + y, x)
            h1 = hl(by + y + 1, x)
            h2 = hl(by + y + 2, x)
            h3 = hl(by + y + 3, x)
            wv = ((((d1 * h1 + d2 * h2) | 0x80000000)
                   - (d0 * h0 + d3 * h3)) & _M64)
            cb = wv >> 32
            if cb >= 1 << 31:
                cb -= 1 << 32
            cr = (wv & 0xFFFFFFFF) ^ 0x80000000
            if cr >= 1 << 31:
                cr -= 1 << 32
            cb_vals[y][x] = cb
            cr_vals[y][x] = cr
    return cb_vals, cr_vals


def store_onedir(plane, y0, x0, vals, shift):
    """store_pix<1> (h265.cpp:3161-3171). The rounding sum is a 32-bit
    int there: a chroma lane value just under 2^31 (the packed lanes'
    form of a negative prediction) wraps to a negative sum and clips to
    0, as the reference decoder, the standard's equations and the JAX
    package's int32 Phase B give; the benchmark's copy wraps it as C
    does, where the JAX package's Python ints gave 255."""
    rnd = 1 << (shift - 1)
    for dy, row in enumerate(vals):
        for dx, v in enumerate(row):
            v = ((v + rnd + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
            plane[y0 + dy, x0 + dx] = _clip255(v >> shift)


def to_bidir(vals, shift):
    """store_pix<0> with the bidir shift (shift-6): raw truncation."""
    s = shift - 6
    if s == 0:
        return [list(r) for r in vals]
    return [[v >> s for v in row] for row in vals]


def writeback_bidir(plane, y0, x0, buf0, vals1, shift1):
    """add_store_pix + writeback (h265.cpp:3173-3178, 3562-3571)."""
    s = shift1 - 6
    for dy, row in enumerate(vals1):
        for dx, v in enumerate(row):
            b = buf0[dy][dx]
            v1 = v >> s if s else v
            plane[y0 + dy, x0 + dx] = (
                _clip255((b + v1 + 64) >> 7)) & 0xFF
