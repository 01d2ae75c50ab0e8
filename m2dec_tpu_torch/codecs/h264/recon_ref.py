"""Reference (numpy) Phase-B interpreter for H.264 PicturePlans.

Reconstructs a picture from the plan tensors alone, reusing the scalar
prediction/transform/deblock kernels — the executable specification the
batched JAX Phase B (reconstruct.py) is verified against.  Mirrors the
reference decode order (raster MBs; within intra MBs coding-order
blocks with per-block residual add; whole-picture deblock post-pass,
reference: src/lib/h264.cpp:10210-10663).
"""

from __future__ import annotations

import numpy as np

from . import pred, pred8x8 as P8, transforms as X
from .deblock import _filter_edge
from .inter import chroma_interp, luma_interp


def _combine(p0, p1, w0, w1, o, s):
    rnd = (1 << (s - 1)) if s else 0
    if p1 is None:
        v = ((p0 * w0 + rnd) >> s) + o
    else:
        v = ((p0 * w0 + p1 * w1 + rnd) >> s) + o
    return np.clip(v, 0, 255)


def _recon_inter_mb(plan, frames, f, mbpos, y0, x0):
    for by in range(4):
        for bx in range(4):
            q = (by >> 1) * 2 + (bx >> 1)
            s0, s1 = int(plan.slot[mbpos, q, 0]), int(plan.slot[mbpos, q, 1])
            if s0 < 0 and s1 < 0:
                continue
            ly, lx_ = y0 + by * 4, x0 + bx * 4
            cy, cx = ly >> 1, lx_ >> 1
            ps = []
            for lx, slot in ((0, s0), (1, s1)):
                if slot < 0:
                    ps.append((None, None, None))
                    continue
                mvx, mvy = (int(v) for v in plan.mv[mbpos, by * 4 + bx, lx])
                rf = frames[slot]
                py = luma_interp(rf.y, lx_ + (mvx >> 2), ly + (mvy >> 2),
                                 4, 4, mvx & 3, mvy & 3)
                pcb = chroma_interp(rf.cb, cx + (mvx >> 3), cy + (mvy >> 3),
                                    2, 2, mvx & 7, mvy & 7)
                pcr = chroma_interp(rf.cr, cx + (mvx >> 3), cy + (mvy >> 3),
                                    2, 2, mvx & 7, mvy & 7)
                ps.append((py, pcb, pcr))
            if s0 < 0:  # single list in slot L1: weights live in w0
                ps = [ps[1], (None, None, None)]
            wp = plan.wp[mbpos, q]
            for pi, pl in enumerate((f.y, f.cb, f.cr)):
                w0, w1, o, s = (int(v) for v in wp[pi])
                p0 = ps[0][pi]
                p1 = ps[1][pi] if (s0 >= 0 and s1 >= 0) else None
                out = _combine(p0, p1, w0, w1, o, s)
                if pi == 0:
                    pl[ly : ly + 4, lx_ : lx_ + 4] = out
                else:
                    pl[cy : cy + 2, cx : cx + 2] = out


_ZPOS = [((i >> 1) & 1) * 4 + ((i >> 3) & 1) * 8 for i in range(16)], [
    (i & 1) * 4 + ((i >> 2) & 1) * 8 for i in range(16)
]


def _add_luma_residual_mb(plan, f, mbpos, y0, x0):
    if plan.t8x8[mbpos]:
        for b in range(4):
            oy, ox = (b >> 1) * 8, (b & 1) * 8
            c = plan.coef_luma[mbpos, b * 64 : b * 64 + 64]
            if c.any():
                X.idct8x8_add(f.y, y0 + oy, x0 + ox, c)
    else:
        for b in range(16):
            oy, ox = (b >> 2) * 4, (b & 3) * 4
            c = plan.coef_luma[mbpos, b * 16 : b * 16 + 16]
            if c.any():
                X.idct4x4_add(f.y, y0 + oy, x0 + ox, c)


def _add_chroma_residual_mb(plan, f, mbpos, cy, cx):
    for ci, pl in ((0, f.cb), (1, f.cr)):
        for b in range(4):
            oy, ox = (b >> 1) * 4, (b & 1) * 4
            c = plan.coef_chroma[mbpos, ci, b]
            if c.any():
                X.idct4x4_add(pl, cy + oy, cx + ox, c)


def _recon_intra_mb(plan, f, mbpos, y0, x0, kind):
    cy, cx = y0 >> 1, x0 >> 1
    if kind == 1:  # intra 4x4: coding order, residual added per block
        for i in range(16):
            by, bx = _ZPOS[0][i], _ZPOS[1][i]
            blk = (by >> 2) * 4 + (bx >> 2)
            pred.INTRA4x4_PRED[int(plan.i4_modes[mbpos, blk])](
                f.y, y0 + by, x0 + bx, int(plan.i4_avail[mbpos, blk]))
            c = plan.coef_luma[mbpos, blk * 16 : blk * 16 + 16]
            if c.any():
                X.idct4x4_add(f.y, y0 + by, x0 + bx, c)
    elif kind == 2:  # intra 8x8
        for b in range(4):
            oy, ox = (b >> 1) * 8, (b & 1) * 8
            P8.INTRA8x8_PRED[int(plan.i8_modes[mbpos, b])](
                f.y, y0 + oy, x0 + ox, int(plan.i8_avail[mbpos, b]))
            c = plan.coef_luma[mbpos, b * 64 : b * 64 + 64]
            if c.any():
                X.idct8x8_add(f.y, y0 + oy, x0 + ox, c)
    else:  # intra 16x16
        avail = int(plan.mb_avail[mbpos])
        pred.INTRA16_PRED[int(plan.i16_mode[mbpos])](f.y, y0, x0, avail)
        for b in range(16):
            oy, ox = (b >> 2) * 4, (b & 3) * 4
            X.idct4x4_add(f.y, y0 + oy, x0 + ox,
                          plan.coef_luma[mbpos, b * 16 : b * 16 + 16])
    avail = int(plan.mb_avail[mbpos])
    mode = int(plan.chroma_mode[mbpos])
    pred.INTRA_CHROMA_PRED[mode](f.cb, cy, cx, avail)
    pred.INTRA_CHROMA_PRED[mode](f.cr, cy, cx, avail)
    _add_chroma_residual_mb(plan, f, mbpos, cy, cx)


def _deblock_np(plan, f):
    mbw = plan.mb_w
    for mbpos in range(plan.n):
        y0, x0 = (mbpos // mbw) * 16, (mbpos % mbw) * 16
        cy, cx = y0 >> 1, x0 >> 1
        for axis in (1, 0):  # vertical edges first, then horizontal
            d = 0 if axis == 1 else 1
            sb = plan.deb_str[mbpos, d]
            ab = plan.deb_ab[mbpos, d]
            str4 = int(plan.deb_str4[mbpos, d])
            if sb[0]:
                _filter_edge(f.y, y0, x0, axis, int(sb[0]), str4,
                             int(ab[0, 0]), int(ab[0, 1]), True, 16)
                for c, pl in ((0, f.cb), (1, f.cr)):
                    _filter_edge(pl, cy, cx, axis, int(sb[0]), str4,
                                 int(ab[1 + c, 0]), int(ab[1 + c, 1]),
                                 False, 8)
            for e in range(1, 4):
                if sb[e]:
                    yy = y0 if axis == 1 else y0 + e * 4
                    xx = x0 + e * 4 if axis == 1 else x0
                    _filter_edge(f.y, yy, xx, axis, int(sb[e]), 0,
                                 int(ab[3, 0]), int(ab[3, 1]), True, 16)
            if sb[2]:
                for c, pl in ((0, f.cb), (1, f.cr)):
                    yy = cy if axis == 1 else cy + 4
                    xx = cx + 4 if axis == 1 else cx
                    _filter_edge(pl, yy, xx, axis, int(sb[2]), 0,
                                 int(ab[4 + c, 0]), int(ab[4 + c, 1]),
                                 False, 8)


def reconstruct_plan_np(plan, frames):
    """Reconstruct plan into frames[plan.cur_idx] (in place), reading
    reference pictures from the same pool."""
    f = frames[plan.cur_idx]
    mbw = plan.mb_w
    for mbpos in range(plan.n):
        y0, x0 = (mbpos // mbw) * 16, (mbpos % mbw) * 16
        kind = int(plan.kind[mbpos])
        if kind == 0:
            _recon_inter_mb(plan, frames, f, mbpos, y0, x0)
            _add_luma_residual_mb(plan, f, mbpos, y0, x0)
            _add_chroma_residual_mb(plan, f, mbpos, y0 >> 1, x0 >> 1)
        elif kind == 4:
            yblk, cbblk, crblk = plan.pcm[mbpos]
            f.y[y0 : y0 + 16, x0 : x0 + 16] = yblk
            f.cb[y0 >> 1 : (y0 >> 1) + 8, x0 >> 1 : (x0 >> 1) + 8] = cbblk
            f.cr[y0 >> 1 : (y0 >> 1) + 8, x0 >> 1 : (x0 >> 1) + 8] = crblk
        else:
            _recon_intra_mb(plan, f, mbpos, y0, x0, kind)
    _deblock_np(plan, f)
