"""H.264 intra prediction (4x4 / 8x8 / 16x16 / chroma), numpy in-place.

Semantics follow ITU-T H.264 8.3, matching the reference's kernels
(reference: src/lib/h264.cpp:2463-2997 intra4x4, :3301-3929 intra8x8,
:4224-4304 + :3041-3065 intra16x16, :4559-4705 chroma). Availability flag
bits: 1=left, 2=top, 4=top-right, 8=top-left (get_availability,
h264.cpp:9704-9715). Functions write the prediction into the plane at
(y0, x0); reconstructed neighbor pixels are read from the same plane
(in-place reconstruction, as the reference does).

Predictions whose required neighbors are unavailable return without
writing, exactly like the reference's early `return -1` paths — decoded
output then depends on pre-existing buffer contents, so conforming
generators never select them.
"""

from __future__ import annotations

import numpy as np


def fir3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def fir2(a, b):
    return (a + b + 1) >> 1


# ---------------------------------------------------------------- 4x4 ----
def _top4(p, y0, x0, n=8):
    return p[y0 - 1, x0 : x0 + n].astype(np.int32)


def pred4_vert(p, y0, x0, avail):
    if not avail & 2:
        return
    p[y0 : y0 + 4, x0 : x0 + 4] = p[y0 - 1, x0 : x0 + 4]


def pred4_horiz(p, y0, x0, avail):
    if not avail & 1:
        return
    p[y0 : y0 + 4, x0 : x0 + 4] = p[y0 : y0 + 4, x0 - 1 : x0]


def pred4_dc(p, y0, x0, avail):
    if avail & 1:
        s_left = int(p[y0 : y0 + 4, x0 - 1].astype(np.int32).sum())
        if avail & 2:
            s_top = int(p[y0 - 1, x0 : x0 + 4].astype(np.int32).sum())
            dc = (s_left + s_top + 4) >> 3
        else:
            dc = (s_left + 2) >> 2
    elif avail & 2:
        dc = (int(p[y0 - 1, x0 : x0 + 4].astype(np.int32).sum()) + 2) >> 2
    else:
        dc = 0x80
    p[y0 : y0 + 4, x0 : x0 + 4] = dc


def pred4_ddl(p, y0, x0, avail):
    t = np.empty(8, np.int32)
    t[:4] = _top4(p, y0, x0, 4)
    if avail & 4:
        t[4:] = _top4(p, y0, x0 + 4, 4)
    else:
        t[4:] = t[3]
    for y in range(4):
        for x in range(4):
            i = x + y
            a, b, c = t[i], t[i + 1], t[min(i + 2, 7)]
            p[y0 + y, x0 + x] = fir3(a, b, c)


def pred4_ddr(p, y0, x0, avail):
    if (avail & 3) != 3:
        return
    top = _top4(p, y0 - 1 + 1, x0, 4)  # row y0-1
    lt = int(p[y0 - 1, x0 - 1])
    left = p[y0 : y0 + 4, x0 - 1].astype(np.int32)
    # build diagonal sample line: left[3..0], lt, top[0..3]
    line = np.concatenate([left[::-1], [lt], top])
    for y in range(4):
        for x in range(4):
            i = 4 + x - y  # index of center sample on the line
            p[y0 + y, x0 + x] = fir3(line[i - 1], line[i], line[i + 1])


def pred4_vr(p, y0, x0, avail):
    """Vertical-Right (8.3.1.2.5)."""
    if (avail & 3) != 3:
        return
    top = _top4(p, y0, x0, 4)
    lt = int(p[y0 - 1, x0 - 1])
    left = p[y0 : y0 + 4, x0 - 1].astype(np.int32)
    tfull = np.concatenate([[lt], top])  # p[k,-1] = tfull[k+1]
    lfull = np.concatenate([[lt], left])  # p[-1,k] = lfull[k+1]
    for y in range(4):
        for x in range(4):
            z = 2 * x - y
            if z >= 0:
                i = x - (y >> 1)
                if z & 1:
                    p[y0 + y, x0 + x] = fir3(tfull[i - 1], tfull[i], tfull[i + 1])
                else:
                    p[y0 + y, x0 + x] = fir2(tfull[i], tfull[i + 1])
            elif z == -1:
                p[y0 + y, x0 + x] = fir3(left[0], lt, top[0])
            else:
                p[y0 + y, x0 + x] = fir3(lfull[y], lfull[y - 1], lfull[y - 2])


def pred4_hd(p, y0, x0, avail):
    """Horizontal-Down (8.3.1.2.6)."""
    if (avail & 3) != 3:
        return
    top = _top4(p, y0, x0, 4)
    lt = int(p[y0 - 1, x0 - 1])
    left = p[y0 : y0 + 4, x0 - 1].astype(np.int32)
    tfull = np.concatenate([[lt], top])
    lfull = np.concatenate([[lt], left])
    for y in range(4):
        for x in range(4):
            z = 2 * y - x
            if z >= 0:
                i = y - (x >> 1)
                if z & 1:
                    p[y0 + y, x0 + x] = fir3(lfull[i - 1], lfull[i], lfull[i + 1])
                else:
                    p[y0 + y, x0 + x] = fir2(lfull[i], lfull[i + 1])
            elif z == -1:
                p[y0 + y, x0 + x] = fir3(top[0], lt, left[0])
            else:
                p[y0 + y, x0 + x] = fir3(tfull[x], tfull[x - 1], tfull[x - 2])


def pred4_vl(p, y0, x0, avail):
    t = np.empty(8, np.int32)
    t[:4] = _top4(p, y0, x0, 4)
    if avail & 4:
        t[4:] = _top4(p, y0, x0 + 4, 4)
    else:
        t[4:] = t[3]
    for y in range(4):
        for x in range(4):
            i = x + (y >> 1)
            if y & 1:
                p[y0 + y, x0 + x] = fir3(t[i], t[i + 1], t[min(i + 2, 7)])
            else:
                p[y0 + y, x0 + x] = fir2(t[i], t[i + 1])


def pred4_hu(p, y0, x0, avail):
    if not avail & 1:
        return
    left = p[y0 : y0 + 4, x0 - 1].astype(np.int32)
    for y in range(4):
        for x in range(4):
            z = x + 2 * y
            if z < 5:
                i = y + (x >> 1)
                if z & 1:
                    p[y0 + y, x0 + x] = fir3(left[i], left[i + 1],
                                             left[min(i + 2, 3)])
                else:
                    p[y0 + y, x0 + x] = fir2(left[i], left[i + 1])
            elif z == 5:
                p[y0 + y, x0 + x] = fir3(left[2], left[3], left[3])
            else:
                p[y0 + y, x0 + x] = left[3]


INTRA4x4_PRED = (pred4_vert, pred4_horiz, pred4_dc, pred4_ddl, pred4_ddr,
                 pred4_vr, pred4_hd, pred4_vl, pred4_hu)


# -------------------------------------------------------------- 16x16 ----
def pred16_vert(p, y0, x0, avail):
    if not avail & 2:
        return
    p[y0 : y0 + 16, x0 : x0 + 16] = p[y0 - 1, x0 : x0 + 16]


def pred16_horiz(p, y0, x0, avail):
    if not avail & 1:
        return
    p[y0 : y0 + 16, x0 : x0 + 16] = p[y0 : y0 + 16, x0 - 1 : x0]


def pred16_dc(p, y0, x0, avail):
    if avail & 1:
        s_left = int(p[y0 : y0 + 16, x0 - 1].astype(np.int32).sum())
        if avail & 2:
            s_top = int(p[y0 - 1, x0 : x0 + 16].astype(np.int32).sum())
            dc = (s_left + s_top + 16) >> 5
        else:
            dc = (s_left + 8) >> 4
    elif avail & 2:
        dc = (int(p[y0 - 1, x0 : x0 + 16].astype(np.int32).sum()) + 8) >> 4
    else:
        dc = 0x80
    p[y0 : y0 + 16, x0 : x0 + 16] = dc


def pred16_plane(p, y0, x0, avail):
    """Planar prediction (8.3.3.4; reference h264.cpp:4224-4304)."""
    top = p[y0 - 1, x0 - 1 : x0 + 16].astype(np.int32)  # [-1..15]
    left = p[y0 - 1 : y0 + 16, x0 - 1].astype(np.int32)  # [-1..15]
    h = sum((x + 1) * (int(top[9 + x]) - int(top[7 - x])) for x in range(8))
    v = sum((y + 1) * (int(left[9 + y]) - int(left[7 - y])) for y in range(8))
    h = (5 * h + 32) >> 6
    v = (5 * v + 32) >> 6
    a = 16 * (int(left[16]) + int(top[16]))
    ys, xs = np.mgrid[0:16, 0:16]
    val = (a + (xs - 7) * h + (ys - 7) * v + 16) >> 5
    p[y0 : y0 + 16, x0 : x0 + 16] = np.clip(val, 0, 255)


INTRA16_PRED = (pred16_vert, pred16_horiz, pred16_dc, pred16_plane)


# -------------------------------------------------------------- chroma ---
def predc_dc(p, y0, x0, avail):
    """Chroma DC over 4x4 sub-blocks on a planar 8x8 plane
    (reference h264.cpp:4581-4623)."""
    blk = p[y0 : y0 + 8, x0 : x0 + 8]

    def sl(yy):
        return int(p[y0 + yy : y0 + yy + 4, x0 - 1].astype(np.int32).sum())

    def st(xx):
        return int(p[y0 - 1, x0 + xx : x0 + xx + 4].astype(np.int32).sum())

    if avail & 1:
        if avail & 2:
            dc0 = (sl(0) + st(0) + 4) >> 3
            dc1 = (st(4) + 2) >> 2
            dc2 = (sl(4) + 2) >> 2
            dc3 = (sl(4) + st(4) + 4) >> 3
        else:
            dc0 = dc1 = (sl(0) + 2) >> 2
            dc2 = dc3 = (sl(4) + 2) >> 2
    elif avail & 2:
        dc0 = dc2 = (st(0) + 2) >> 2
        dc1 = dc3 = (st(4) + 2) >> 2
    else:
        dc0 = dc1 = dc2 = dc3 = 0x80
    blk[0:4, 0:4] = dc0
    blk[0:4, 4:8] = dc1
    blk[4:8, 0:4] = dc2
    blk[4:8, 4:8] = dc3


def predc_horiz(p, y0, x0, avail):
    if not avail & 1:
        return
    p[y0 : y0 + 8, x0 : x0 + 8] = p[y0 : y0 + 8, x0 - 1 : x0]


def predc_vert(p, y0, x0, avail):
    if not avail & 2:
        return
    p[y0 : y0 + 8, x0 : x0 + 8] = p[y0 - 1, x0 : x0 + 8]


def predc_plane(p, y0, x0, avail):
    """Chroma planar (8.3.4.4; reference h264.cpp:4644-4705)."""
    top = p[y0 - 1, x0 - 1 : x0 + 8].astype(np.int32)
    left = p[y0 - 1 : y0 + 8, x0 - 1].astype(np.int32)
    h = sum((x + 1) * (int(top[5 + x]) - int(top[3 - x])) for x in range(4))
    v = sum((y + 1) * (int(left[5 + y]) - int(left[3 - y])) for y in range(4))
    h = (17 * h + 16) >> 5
    v = (17 * v + 16) >> 5
    a = 16 * (int(left[8]) + int(top[8]))
    ys, xs = np.mgrid[0:8, 0:8]
    val = (a + (xs - 3) * h + (ys - 3) * v + 16) >> 5
    p[y0 : y0 + 8, x0 : x0 + 8] = np.clip(val, 0, 255)


INTRA_CHROMA_PRED = (predc_dc, predc_horiz, predc_vert, predc_plane)
