"""H.264 inverse transforms + dequantization, numpy.

Semantics mirror the reference exactly (reference: src/lib/h264.cpp):
* dequant matrices = normAdjust[qp%6] << (qp/6), flat scaling lists
  (qp_matrix :964-995, qp_matrix8x8 :997-1054 with shift qp/6-2);
* coefficient parse multiplies level * qmat (coeff_writeback :2005-2022),
  so `coeff` arrays arriving here are already scaled; DC coefficients are
  transformed separately and substituted (intra16x16_dc_transform
  :4309-4365, chroma DC :4387-4404);
* inverse transforms run horizontal-then-vertical with +32 folded into the
  (0,0) coefficient, final >>6 and clip-add into the frame (4x4
  :2272-2360, 8x8 :3986-4068) — identical to the spec's (g+32)>>6;
* DC-only fast paths add (dc+32)>>6 to all samples (:2113-2130).

All functions operate on planar numpy planes in place.
"""

from __future__ import annotations

import numpy as np

from . import tables as T


def qmat4(qp):
    """16-entry 4x4 dequant matrix, raster order (reference qp_matrix)."""
    v0, v1, v2 = (x << (qp // 6) for x in T.NORM_ADJUST4[qp % 6])
    m = np.empty(16, np.int64)
    for i in range(16):
        r, c = i >> 2, i & 3
        m[i] = v0 if not (r & 1 or c & 1) else (v1 if (r & 1 and c & 1) else v2)
    return m


def qmat8(qp):
    """64-entry 8x8 dequant matrix; shift qp//6-2 (reference qp_matrix8x8)."""
    shift = qp // 6 - 2
    vals = [(x << shift) if shift >= 0 else (x >> -shift)
            for x in T.NORM_ADJUST8[qp % 6]]
    m = np.empty(64, np.int64)
    for i in range(64):
        r, c = i >> 3, i & 7
        rm, cm = r & 3, c & 3
        if rm == 0 and cm == 0:
            k = 0
        elif (r & 1) and (c & 1):
            k = 1
        elif rm == 2 and cm == 2:
            k = 2
        elif (rm == 0 and (c & 1)) or (cm == 0 and (r & 1)):
            k = 3
        elif rm == 0 or cm == 0:
            k = 4
        else:
            k = 5
        m[i] = vals[k]
    return m


def qpc_from_qpy(qpy, qpc_diff):
    """h264.cpp:1056-1075."""
    qpc = qpy + qpc_diff
    if qpc <= 0:
        return 0
    if qpc >= 30:
        return T.QPC_ADJUST[min(qpc, 51) - 30]
    return qpc


def _stage4(rows):
    """1D 4-point inverse stage along the last axis."""
    e0 = rows[..., 0] + rows[..., 2]
    e1 = rows[..., 0] - rows[..., 2]
    e2 = (rows[..., 1] >> 1) - rows[..., 3]
    e3 = rows[..., 1] + (rows[..., 3] >> 1)
    return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)


def idct4x4(coeff):
    """4x4 inverse transform core -> int residual (pre clip-add)."""
    c = np.asarray(coeff, np.int64).reshape(4, 4).copy()
    c[0, 0] += 32
    f = _stage4(c)  # horizontal, within rows
    g = _stage4(f.T).T  # vertical, within columns
    return g >> 6


def idct4x4_add(plane, y0, x0, coeff):
    res = idct4x4(coeff)
    blk = plane[y0 : y0 + 4, x0 : x0 + 4].astype(np.int64)
    plane[y0 : y0 + 4, x0 : x0 + 4] = np.clip(blk + res, 0, 255)


def idct4x4_dconly_add(plane, y0, x0, dc):
    v = (int(dc) + 32) >> 6
    blk = plane[y0 : y0 + 4, x0 : x0 + 4].astype(np.int64)
    plane[y0 : y0 + 4, x0 : x0 + 4] = np.clip(blk + v, 0, 255)


def _stage8(rows):
    """1D 8-point inverse stage (reference ac8x8transform_interim)."""
    s = rows
    t0 = s[..., 0] + s[..., 4]
    t2 = s[..., 0] - s[..., 4]
    t4 = (s[..., 2] >> 1) - s[..., 6]
    t6 = s[..., 2] + (s[..., 6] >> 1)
    s1, s3, s5, s7 = s[..., 1], s[..., 3], s[..., 5], s[..., 7]
    t1 = s5 - s3 - s7 - (s7 >> 1)
    t7 = s3 + s5 + s1 + (s1 >> 1)
    t3 = s1 + s7 - s3 - (s3 >> 1)
    t5 = s5 + (s5 >> 1) + s7 - s1
    t0, t6 = t0 + t6, t0 - t6
    t2, t4 = t2 + t4, t2 - t4
    t1, t7 = t1 + (t7 >> 2), t7 - (t1 >> 2)
    t3, t5 = t3 + (t5 >> 2), (t3 >> 2) - t5
    return np.stack(
        [t0 + t7, t2 + t5, t4 + t3, t6 + t1, t6 - t1, t4 - t3, t2 - t5, t0 - t7],
        axis=-1,
    )


def idct8x8(coeff):
    c = np.asarray(coeff, np.int64).reshape(8, 8).copy()
    c[0, 0] += 32
    f = _stage8(c)  # horizontal
    g = _stage8(f.T).T  # vertical
    return g >> 6


def idct8x8_add(plane, y0, x0, coeff):
    res = idct8x8(coeff)
    blk = plane[y0 : y0 + 8, x0 : x0 + 8].astype(np.int64)
    plane[y0 : y0 + 8, x0 : x0 + 8] = np.clip(blk + res, 0, 255)


def idct8x8_dconly_add(plane, y0, x0, dc):
    v = (int(dc) + 32) >> 6
    blk = plane[y0 : y0 + 8, x0 : x0 + 8].astype(np.int64)
    plane[y0 : y0 + 8, x0 : x0 + 8] = np.clip(blk + v, 0, 255)


_H4 = np.array(
    [[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int64
)


def luma_dc_transform(coeff16):
    """Intra16x16 luma DC Hadamard (h264.cpp:4309-4365).

    coeff16: int[16] raster 4x4 of scaled DC coefficients. Returns int[16]
    of per-4x4-block DC values, spatial raster order.
    """
    x = np.asarray(coeff16, np.int64).reshape(4, 4)
    t = _H4 @ x @ _H4
    return ((t + 2) >> 2).reshape(16)


def chroma_dc_transform(coeff4):
    """2x2 chroma DC (h264.cpp:4387-4404); raster order in/out."""
    c0, c1, c2, c3 = (int(x) for x in coeff4[:4])
    t0, t1 = c0 + c1, c2 + c3
    u0, u1 = c0 - c1, c2 - c3
    return [(t0 + t1) >> 1, (u0 + u1) >> 1, (t0 - t1) >> 1, (u0 - u1) >> 1]
