"""H.264 inter prediction: quarter-pel interpolation, MV prediction,
P-macroblock decode, skip, and inter deblock-strength recording.

Behavioral mirror of the reference (reference: src/lib/h264.cpp):
* luma 6-tap quarter-pel (:5332-6261 filter set; spec 8.4.2.2.1 positions),
  chroma 1/8-pel bilinear (:4859-5296), UMV via coordinate clamping
  (equivalent to the reference's edge-fill buffers :5932-6117);
* MV prediction calc_mv16x16/16x8/8x16/8x8-sub (:6690-6724, :7379-7449,
  :7657-7744, :7873-8323) including all neighbor/idx_map special cases;
* P_Skip (:9736-9766) and the skip run (:10128-10183);
* store_info_inter* neighbor/colocated updates and the packed 2-bit
  deblock strength computation (:7119-7322, :7451-7604, :7776-7821,
  :8796-9400).

Bi-directional combine is AVERAGE2 (round-up; :5298-5302).
"""

from __future__ import annotations

import numpy as np

MB_PSKIP = 31


# ---------------------------------------------------------------------
# interpolation kernels
# ---------------------------------------------------------------------
def _gather(plane, ys, xs):
    h, w = plane.shape
    return plane[np.clip(ys, 0, h - 1)[:, None], np.clip(xs, 0, w - 1)[None, :]].astype(np.int64)


def _clip255(a):
    return np.clip(a, 0, 255)


def luma_interp(plane, posx, posy, bw, bh, fracx, fracy):
    """Quarter-pel luma block (spec 8.4.2.2.1/8.4.2.2.2); returns int64
    [bh, bw] in 0..255. posx/posy = integer sample position of the top-left
    full-pel sample (mv>>2 applied); coordinates clamp at picture edges."""
    ys = posy + np.arange(-2, bh + 3)
    xs = posx + np.arange(-2, bw + 3)
    g = _gather(plane, ys, xs)  # [bh+5, bw+5]

    def tap6(a):  # along last axis, windows of 6
        return (a[..., :-5] - 5 * a[..., 1:-4] + 20 * a[..., 2:-3]
                + 20 * a[..., 3:-2] - 5 * a[..., 4:-1] + a[..., 5:])

    G = g[2 : 2 + bh, 2 : 2 + bw]
    if fracx == 0 and fracy == 0:
        return G
    # b: horizontal half-pel at integer rows
    b_full = _clip255((tap6(g) + 16) >> 5)  # [bh+5, bw]
    b = b_full[2 : 2 + bh]
    # h: vertical half-pel at integer cols
    h_full = _clip255((tap6(g.T).T + 16) >> 5)  # [bh, bw+5]
    h = h_full[:, 2 : 2 + bw]
    if fracy == 0:
        if fracx == 1:
            return (G + b + 1) >> 1
        if fracx == 2:
            return b
        return (g[2 : 2 + bh, 3 : 3 + bw] + b + 1) >> 1  # c = avg(H, b)
    if fracx == 0:
        if fracy == 1:
            return (G + h + 1) >> 1
        if fracy == 2:
            return h
        return (g[3 : 3 + bh, 2 : 2 + bw] + h + 1) >> 1  # n = avg(M, h)
    # need j (and possibly shifted b/h)
    raw_b = tap6(g)  # [bh+5, bw] un-clipped, un-shifted
    j_raw = tap6(raw_b.T).T  # vertical 6-tap over raw half sums -> [bh, bw]
    j = _clip255((j_raw + 512) >> 10)
    if fracx == 2 and fracy == 2:
        return j
    if fracy == 2:  # (2, 1)=i avg(h, j); (2, 3)=k avg(j, m)
        if fracx == 1:
            return (h + j + 1) >> 1
        m = h_full[:, 3 : 3 + bw]
        return (j + m + 1) >> 1
    if fracx == 2:  # (1, 2)=f avg(b, j); (3, 2)=q avg(j, s)
        if fracy == 1:
            return (b + j + 1) >> 1
        s = b_full[3 : 3 + bh]
        return (j + s + 1) >> 1
    # diagonal quarters: e/g/p/r = avg of nearest b and h
    bb = b if fracy == 1 else b_full[3 : 3 + bh]  # s when fracy==3
    hh = h if fracx == 1 else h_full[:, 3 : 3 + bw]  # m when fracx==3
    return (bb + hh + 1) >> 1


def chroma_interp(plane, posx, posy, bw, bh, fracx, fracy):
    """1/8-pel chroma bilinear (spec 8.4.2.2.2; reference filter_chroma_*)."""
    ys = posy + np.arange(0, bh + 1)
    xs = posx + np.arange(0, bw + 1)
    g = _gather(plane, ys, xs)
    a = g[:bh, :bw]
    b = g[:bh, 1 : bw + 1]
    c = g[1 : bh + 1, :bw]
    d = g[1 : bh + 1, 1 : bw + 1]
    return (
        (8 - fracx) * (8 - fracy) * a
        + fracx * (8 - fracy) * b
        + (8 - fracx) * fracy * c
        + fracx * fracy * d
        + 32
    ) >> 6


def avg_round_up(a, b):
    """AVERAGE2 (h264.cpp:5298-5302): (a+b+1)>>1."""
    return (a + b + 1) >> 1


# ---------------------------------------------------------------------
# part prediction (inter_pred_basic, h264.cpp:6726-6749)
# ---------------------------------------------------------------------
def _pred_one(dec, lx, idx, mv, bw, bh, x0, y0):
    frm = dec.frames[dec.refs[lx][idx].frame_idx]
    mvx, mvy = int(mv[0]), int(mv[1])
    py = luma_interp(frm.y, x0 + (mvx >> 2), y0 + (mvy >> 2), bw, bh,
                     mvx & 3, mvy & 3)
    cx = (x0 >> 1) + (mvx >> 3)
    cy = (y0 >> 1) + (mvy >> 3)
    pcb = chroma_interp(frm.cb, cx, cy, bw >> 1, bh >> 1, mvx & 7, mvy & 7)
    pcr = chroma_interp(frm.cr, cx, cy, bw >> 1, bh >> 1, mvx & 7, mvy & 7)
    return py, pcb, pcr


def _store_pred(dec, x0, y0, bw, bh, out_y, out_cb, out_cr):
    f = dec.frames[dec.cur_idx]
    f.y[y0 : y0 + bh, x0 : x0 + bw] = out_y
    cx0, cy0 = x0 >> 1, y0 >> 1
    f.cb[cy0 : cy0 + (bh >> 1), cx0 : cx0 + (bw >> 1)] = out_cb
    f.cr[cy0 : cy0 + (bh >> 1), cx0 : cx0 + (bw >> 1)] = out_cr


def inter_pred_basic(dec, ref_idx, mv, bw, bh, offsetx, offsety):
    """Predict one partition into the current frame. ref_idx: [2], mv:
    [2][2] (list, xy). Routes through the slice's weighted-prediction
    mode like the reference's mb->inter_pred pointer
    (set_weighted_info, h264.cpp:1387-1403)."""
    wm = dec.weighted_mode
    if wm == 1:
        return _inter_pred_weighted1(dec, ref_idx, mv, bw, bh,
                                     offsetx, offsety)
    if wm == 2:
        return _inter_pred_weighted2(dec, ref_idx, mv, bw, bh,
                                     offsetx, offsety)
    x0 = dec.mb_x * 16 + offsetx
    y0 = dec.mb_y * 16 + offsety
    bidir = 0
    out_y = out_cb = out_cr = None
    for lx in range(2):
        idx = int(ref_idx[lx])
        if idx < 0:
            continue
        py, pcb, pcr = _pred_one(dec, lx, idx, mv[lx], bw, bh, x0, y0)
        if bidir:
            out_y = avg_round_up(out_y, py)
            out_cb = avg_round_up(out_cb, pcb)
            out_cr = avg_round_up(out_cr, pcr)
        else:
            out_y, out_cb, out_cr = py, pcb, pcr
        bidir += 1
    if out_y is None:
        return
    if dec.rec is not None:
        _rec_inter(dec, ref_idx, mv, bw, bh, x0, y0,
                   [(1, 1, 0, 1)] * 3 if bidir == 2 else [(1, 0, 0, 0)] * 3)
    _store_pred(dec, x0, y0, bw, bh, out_y, out_cb, out_cr)


def _rec_inter(dec, ref_idx, mv, bw, bh, x0, y0, wp3x4):
    """Plan-recorder tap (plan.py): resolve ref slots and emit the
    partition's 4x4-block records."""
    slots = [-1, -1]
    for lx in range(2):
        idx = int(ref_idx[lx])
        if idx >= 0:
            slots[lx] = dec.refs[lx][idx].frame_idx
    dec.rec.inter(x0, y0, bw, bh, slots, mv, wp3x4)


# ---------------------------------------------------------------------
# weighted prediction (h264.cpp:6762-7115)
# ---------------------------------------------------------------------
def _wcopy(p, w, o, shift):
    """weighted_copy_base (h264.cpp:6812-6828)."""
    rnd = (1 << (shift - 1)) if shift else 0
    v = ((p.astype(np.int64) * w + rnd) >> shift) + o
    return np.clip(v, 0, 255).astype(np.uint8)


def _wbidir1(p0, p1, w0, w1, o0, o1, shift):
    """add_bidir_weighted_type1 scalar (h264.cpp:6953-6974)."""
    rnd = 1 << shift
    v = ((p1.astype(np.int64) * w1 + p0.astype(np.int64) * w0 + rnd)
         >> (shift + 1)) + ((o0 + o1 + 1) >> 1)
    return np.clip(v, 0, 255).astype(np.uint8)


def _inter_pred_weighted1(dec, ref_idx, mv, bw, bh, offsetx, offsety):
    """inter_pred_weighted1 (h264.cpp:6981-6999), explicit weights."""
    x0 = dec.mb_x * 16 + offsetx
    y0 = dec.mb_y * 16 + offsety
    sy, sc = dec.weight_shift
    r0, r1 = int(ref_idx[0]), int(ref_idx[1])
    if r0 >= 0 and r1 >= 0:
        w0 = dec.weight_tab[0][r0]  # ((wl,ol),(wcb,ocb),(wcr,ocr))
        w1 = dec.weight_tab[1][r1]
        py0, pcb0, pcr0 = _pred_one(dec, 0, r0, mv[0], bw, bh, x0, y0)
        py1, pcb1, pcr1 = _pred_one(dec, 1, r1, mv[1], bw, bh, x0, y0)
        oy = _wbidir1(py0, py1, w0[0][0], w1[0][0], w0[0][1], w1[0][1], sy)
        ocb = _wbidir1(pcb0, pcb1, w0[1][0], w1[1][0], w0[1][1], w1[1][1], sc)
        ocr = _wbidir1(pcr0, pcr1, w0[2][0], w1[2][0], w0[2][1], w1[2][1], sc)
        if dec.rec is not None:
            wp = [(w0[p][0], w1[p][0], (w0[p][1] + w1[p][1] + 1) >> 1,
                   (sy if p == 0 else sc) + 1) for p in range(3)]
            _rec_inter(dec, ref_idx, mv, bw, bh, x0, y0, wp)
    else:
        lx = 0 if r0 >= 0 else 1
        idx = r0 if r0 >= 0 else r1
        w = dec.weight_tab[lx][idx]
        py, pcb, pcr = _pred_one(dec, lx, idx, mv[lx], bw, bh, x0, y0)
        oy = _wcopy(py, w[0][0], w[0][1], sy)
        ocb = _wcopy(pcb, w[1][0], w[1][1], sc)
        ocr = _wcopy(pcr, w[2][0], w[2][1], sc)
        if dec.rec is not None:
            wp = [(w[p][0], 0, w[p][1], sy if p == 0 else sc)
                  for p in range(3)]
            _rec_inter(dec, ref_idx, mv, bw, bh, x0, y0, wp)
    _store_pred(dec, x0, y0, bw, bh, oy, ocb, ocr)


def _implicit_weights(dec, idx0, idx1):
    """pred_weight_type2 (h264.cpp:7001-7035)."""
    from .bdirect import dist_scale_factor
    from .dpb import SHORT_TERM

    r0 = dec.refs[0][idx0]
    r1 = dec.refs[1][idx1]
    if (r0.poc == r1.poc or r0.in_use != SHORT_TERM
            or r1.in_use != SHORT_TERM):
        return 32, 32
    w1 = dist_scale_factor(r0.poc, r1.poc, dec.hdr.poc) >> 2
    if w1 < -64 or w1 > 128:
        return 32, 32
    return 64 - w1, w1


def _inter_pred_weighted2(dec, ref_idx, mv, bw, bh, offsetx, offsety):
    """inter_pred_weighted2 (h264.cpp:7103-7118), implicit weights."""
    r0, r1 = int(ref_idx[0]), int(ref_idx[1])
    if r0 < 0 or r1 < 0:
        x0 = dec.mb_x * 16 + offsetx
        y0 = dec.mb_y * 16 + offsety
        lx = 0 if r0 >= 0 else 1
        idx = r0 if r0 >= 0 else r1
        py, pcb, pcr = _pred_one(dec, lx, idx, mv[lx], bw, bh, x0, y0)
        if dec.rec is not None:
            _rec_inter(dec, ref_idx, mv, bw, bh, x0, y0, [(1, 0, 0, 0)] * 3)
        _store_pred(dec, x0, y0, bw, bh, py, pcb, pcr)
        return
    w0, w1 = _implicit_weights(dec, r0, r1)
    x0 = dec.mb_x * 16 + offsetx
    y0 = dec.mb_y * 16 + offsety
    py0, pcb0, pcr0 = _pred_one(dec, 0, r0, mv[0], bw, bh, x0, y0)
    py1, pcb1, pcr1 = _pred_one(dec, 1, r1, mv[1], bw, bh, x0, y0)

    def comb(a, b):
        v = (b.astype(np.int64) * w1 + a.astype(np.int64) * w0 + 32) >> 6
        return np.clip(v, 0, 255).astype(np.uint8)

    if dec.rec is not None:
        _rec_inter(dec, ref_idx, mv, bw, bh, x0, y0, [(w0, w1, 0, 6)] * 3)
    _store_pred(dec, x0, y0, bw, bh, comb(py0, py1), comb(pcb0, pcb1),
                comb(pcr0, pcr1))


# ---------------------------------------------------------------------
# MV prediction helpers
# ---------------------------------------------------------------------
ZMV = np.zeros(2, np.int32)


def median(a, b, c):
    return (b if b <= c else (c if a <= c else a)) if a <= b else (a if a <= c else (c if b <= c else b))


def determine_pmv(mva, mvb, mvc, avail, idx_map):
    """h264.cpp:6669-6688."""
    if (avail & 7) == 1 or idx_map == 1:
        return int(mva[0]), int(mva[1])
    if 0xE9 & (1 << idx_map):
        return (median(int(mva[0]), int(mvb[0]), int(mvc[0])),
                median(int(mva[1]), int(mvb[1]), int(mvc[1])))
    if idx_map == 2:
        return int(mvb[0]), int(mvb[1])
    return int(mvc[0]), int(mvc[1])


def calc_mv16x16(dec, lx, ref_idx, avail):
    """h264.cpp:6690-6724. Returns (pmv, mvd_a, mvd_b)."""
    left, top, topr = dec.mbleft, dec._top(), dec._topright()
    idx_map = 0
    if avail & 1:
        idx_map = int(ref_idx == left.ref[0][lx])
        mva = left.mov[0][lx]
        mvd_a = left.mvd[0][lx]
    else:
        mva = mvd_a = ZMV
    if avail & 2:
        idx_map |= int(ref_idx == top.ref[0][lx]) * 2
        mvb = top.mov[0][lx]
        mvd_b = top.mvd[0][lx]
    else:
        mvb = mvd_b = ZMV
    if avail & 4:
        idx_map |= int(ref_idx == topr.ref[0][lx]) * 4
        mvc = topr.mov[0][lx]
    elif avail & 8:
        idx_map |= int(ref_idx == dec.lefttop_ref[lx]) * 4
        mvc = dec.lefttop_mv[lx]
    else:
        mvc = ZMV
    return determine_pmv(mva, mvb, mvc, avail, idx_map), mvd_a, mvd_b


def calc_mv16x8top(dec, lx, ref_idx, avail):
    """h264.cpp:7379-7418."""
    left, top, topr = dec.mbleft, dec._top(), dec._topright()
    if avail & 2:
        mvd_b = top.mvd[0][lx]
        if ref_idx == top.ref[0][lx]:
            mvd_a = left.mvd[0][lx] if avail & 1 else ZMV
            return (int(top.mov[0][lx][0]), int(top.mov[0][lx][1])), mvd_a, mvd_b
        mvb = top.mov[0][lx]
    else:
        mvb = mvd_b = ZMV
    if avail & 1:
        idx_map = int(ref_idx == left.ref[0][lx])
        mva = left.mov[0][lx]
        mvd_a = left.mvd[0][lx]
    else:
        mva = mvd_a = ZMV
        idx_map = 0
    if avail & 4:
        idx_map |= int(ref_idx == topr.ref[0][lx]) * 4
        mvc = topr.mov[0][lx]
    elif avail & 8:
        idx_map |= int(ref_idx == dec.lefttop_ref[lx]) * 4
        mvc = dec.lefttop_mv[lx]
    else:
        mvc = ZMV
    if avail & 2:
        idx_map |= int(ref_idx == top.ref[0][lx]) * 2
    return determine_pmv(mva, mvb, mvc, avail, idx_map), mvd_a, mvd_b


def calc_mv16x8bottom(dec, lx, ref_idx, avail, prev_ref, prev_mv, prev_mvd):
    """h264.cpp:7420-7449."""
    left = dec.mbleft
    if avail & 1:
        mvd_a = left.mvd[2][lx]
        if ref_idx == left.ref[1][lx]:
            return (int(left.mov[2][lx][0]), int(left.mov[2][lx][1])), mvd_a, prev_mvd[lx]
        idx_map = int(ref_idx == left.ref[0][lx]) * 4
        mva = left.mov[2][lx]
        mvc = left.mov[1][lx]
    else:
        idx_map = 0
        mva = mvd_a = ZMV
        mvc = ZMV
    mvb = prev_mv[lx]
    mvd_b = prev_mvd[lx]
    idx_map |= int(ref_idx == prev_ref) * 2
    return determine_pmv(mva, mvb, mvc, avail | 2, idx_map), mvd_a, mvd_b


def calc_mv8x16left(dec, lx, ref_idx, avail):
    """h264.cpp:7657-7696."""
    left, top = dec.mbleft, dec._top()
    if avail & 1:
        mvd_a = left.mvd[0][lx]
        if ref_idx == left.ref[0][lx]:
            mvd_b = top.mvd[0][lx] if avail & 2 else ZMV
            return (int(left.mov[0][lx][0]), int(left.mov[0][lx][1])), mvd_a, mvd_b
        mva = left.mov[0][lx]
    else:
        mva = mvd_a = ZMV
    idx_map = 0
    if avail & 2:
        idx_map |= int(ref_idx == top.ref[0][lx]) * 2
        idx_map |= int(ref_idx == top.ref[1][lx]) * 4
        avail |= 4
        mvb = top.mov[0][lx]
        mvd_b = top.mvd[0][lx]
        mvc = top.mov[2][lx]
    else:
        mvb = mvd_b = ZMV
        avail &= ~4
        if avail & 8:
            idx_map |= int(ref_idx == dec.lefttop_ref[lx]) * 4
            mvc = dec.lefttop_mv[lx]
        else:
            mvc = ZMV
    if avail & 1 and ref_idx == left.ref[0][lx]:
        idx_map |= 1
    return determine_pmv(mva, mvb, mvc, avail, idx_map), mvd_a, mvd_b


def calc_mv8x16right(dec, lx, ref_idx, avail, prev_ref, prev_mv, prev_mvd):
    """h264.cpp:7698-7744."""
    top, topr = dec._top(), dec._topright()
    idx_map = 0
    mvd_b = None
    if avail & 4:
        if ref_idx == topr.ref[0][lx]:
            mvd_a = prev_mvd[lx]
            mvd_b = top.mvd[2][lx] if avail & 2 else ZMV
            return (int(topr.mov[0][lx][0]), int(topr.mov[0][lx][1])), mvd_a, mvd_b
        mvc = topr.mov[0][lx]
    elif avail & 2:
        idx_map = int(ref_idx == top.ref[0][lx]) * 4
        mvd_b = top.mvd[2][lx]
        if idx_map:
            mvd_a = prev_mvd[lx]
            return (int(top.mov[1][lx][0]), int(top.mov[1][lx][1])), mvd_a, mvd_b
        mvc = top.mov[1][lx]
    else:
        mvc = ZMV
    idx_map |= int(ref_idx == prev_ref)
    mva = prev_mv[lx]
    mvd_a = prev_mvd[lx]
    avail |= 1
    if avail & 2:
        idx_map |= int(ref_idx == top.ref[1][lx]) * 2
        mvb = top.mov[2][lx]
        mvd_b = top.mvd[2][lx]
    else:
        mvb = ZMV
        mvd_b = ZMV
    return determine_pmv(mva, mvb, mvc, avail, idx_map), mvd_a, mvd_b


def calc_mv8x8(dec, sub_kind, lx, ref_idx, avail, blk_idx, pblk, sub):
    """calc_mv8x8_sub{8x8,8x4,4x8,4x4} (h264.cpp:7873-8323).

    sub_kind: 0=8x8, 1=8x4 (sub=y), 2=4x8 (sub=x), 3=4x4 (sub=xy).
    pblk: list of 4 Prev8x8. Returns (pmv, mvd_a, mvd_b)."""
    left, top, topr = dec.mbleft, dec._top(), dec._topright()
    idx_map = 0
    # --- A neighbor ---
    if sub_kind == 2 and sub != 0:  # 4x8 right half
        idx_map = 1
        mva = pblk[blk_idx].mv[0][lx]
        mvd_a = pblk[blk_idx].mvd[0][lx]
        avail |= 1
    elif sub_kind == 3 and (sub & 1):
        idx_map = 1
        mva = pblk[blk_idx].mv[sub - 1][lx]
        mvd_a = pblk[blk_idx].mvd[sub - 1][lx]
        avail |= 1
    elif blk_idx & 1:
        idx_map = int(ref_idx == pblk[blk_idx - 1].ref[lx])
        if sub_kind == 1:
            mva = pblk[blk_idx - 1].mv[sub * 2 + 1][lx]
            mvd_a = pblk[blk_idx - 1].mvd[sub * 2 + 1][lx]
        elif sub_kind == 3:
            mva = pblk[blk_idx - 1].mv[sub + 1][lx]
            mvd_a = pblk[blk_idx - 1].mvd[sub + 1][lx]
        else:
            mva = pblk[blk_idx - 1].mv[1][lx]
            mvd_a = pblk[blk_idx - 1].mvd[1][lx]
        avail |= 1
    elif avail & 1:
        idx_map = int(ref_idx == left.ref[blk_idx >> 1][lx])
        if sub_kind == 1:
            k = (blk_idx & 2) + sub
        elif sub_kind == 3:
            k = blk_idx + (sub >> 1)
        else:
            k = blk_idx
        mva = left.mov[k][lx]
        mvd_a = left.mvd[k][lx]
    else:
        mva = mvd_a = ZMV
    # --- B neighbor ---
    if sub_kind == 1 and sub != 0:
        idx_map |= 2
        mvb = pblk[blk_idx].mv[0][lx]
        mvd_b = pblk[blk_idx].mvd[0][lx]
        avail |= 2
    elif sub_kind == 3 and (sub & 2):
        idx_map |= 2
        mvb = pblk[blk_idx].mv[sub - 2][lx]
        mvd_b = pblk[blk_idx].mvd[sub - 2][lx]
        avail |= 2
    elif blk_idx & 2:
        idx_map |= int(ref_idx == pblk[blk_idx - 2].ref[lx]) * 2
        if sub_kind in (2, 3):
            x = sub if sub_kind == 2 else (sub & 1)
            mvb = pblk[blk_idx - 2].mv[2 + x][lx]
            mvd_b = pblk[blk_idx - 2].mvd[2 + x][lx]
        else:
            mvb = pblk[blk_idx - 2].mv[2][lx]
            mvd_b = pblk[blk_idx - 2].mvd[2][lx]
        avail |= 2
    elif avail & 2:
        if sub_kind == 1:
            ri = blk_idx & 1
        elif sub_kind in (2, 3):
            ri = blk_idx & 1
        else:
            ri = blk_idx
        idx_map |= int(ref_idx == top.ref[ri][lx]) * 2
        if sub_kind == 2:
            k = blk_idx * 2 + sub
        elif sub_kind == 3:
            k = blk_idx * 2 + (sub & 1)
        else:
            k = blk_idx * 2
        mvb = top.mov[k][lx]
        mvd_b = top.mvd[k][lx]
    else:
        mvb = mvd_b = ZMV
    # --- C neighbor (per-sub-kind switch tables) ---
    mvc, idx_c, avail = _calc8x8_c(dec, sub_kind, lx, ref_idx, avail,
                                   blk_idx, pblk, sub)
    idx_map |= idx_c
    return determine_pmv(mva, mvb, mvc, avail, idx_map), mvd_a, mvd_b


def _calc8x8_c(dec, sub_kind, lx, ref_idx, avail, blk_idx, pblk, sub):
    left, top, topr = dec.mbleft, dec._top(), dec._topright()
    idx = 0
    if sub_kind == 0:  # 8x8
        if blk_idx == 0:
            if avail & 2:
                idx = int(ref_idx == top.ref[1][lx]) * 4
                return top.mov[2][lx], idx, avail | 4
            if avail & 8:
                idx = int(ref_idx == dec.lefttop_ref[lx]) * 4
                return dec.lefttop_mv[lx], idx, avail | 4
            return ZMV, 0, avail & ~4
        if blk_idx == 1:
            if avail & 4:
                idx = int(ref_idx == topr.ref[0][lx]) * 4
                return topr.mov[0][lx], idx, avail
            if avail & 2:
                idx = int(ref_idx == top.ref[0][lx]) * 4
                return top.mov[1][lx], idx, avail
            return ZMV, 0, avail
        if blk_idx == 2:
            idx = int(ref_idx == pblk[1].ref[lx]) * 4
            return pblk[1].mv[2][lx], idx, avail | 4
        idx = int(ref_idx == pblk[0].ref[lx]) * 4
        return pblk[0].mv[3][lx], idx, avail | 4
    if sub_kind == 1:  # 8x4, sub = y
        y = sub
        if blk_idx == 0:
            if y == 0:
                if avail & 2:
                    idx = int(ref_idx == top.ref[1][lx]) * 4
                    return top.mov[2][lx], idx, avail | 4
                if avail & 8:
                    idx = int(ref_idx == dec.lefttop_ref[lx]) * 4
                    return dec.lefttop_mv[lx], idx, avail | 4
                return ZMV, 0, avail & ~4
            if avail & 1:
                idx = int(ref_idx == left.ref[0][lx]) * 4
                return left.mov[0][lx], idx, avail | 4
            return ZMV, 0, avail & ~4
        if blk_idx == 1:
            if y == 0:
                if avail & 4:
                    idx = int(ref_idx == topr.ref[0][lx]) * 4
                    return topr.mov[0][lx], idx, avail | 4
                if avail & 2:
                    idx = int(ref_idx == top.ref[0][lx]) * 4
                    return top.mov[1][lx], idx, avail | 4
                return ZMV, 0, avail
            idx = int(ref_idx == pblk[0].ref[lx]) * 4
            return pblk[0].mv[1][lx], idx, avail | 4
        if blk_idx == 2:
            if y == 0:
                idx = int(ref_idx == pblk[1].ref[lx]) * 4
                return pblk[1].mv[2][lx], idx, avail | 4
            if avail & 1:
                idx = int(ref_idx == left.ref[1][lx]) * 4
                return left.mov[2][lx], idx, avail | 4
            return ZMV, 0, avail & ~4
        idx = int(ref_idx == pblk[y * 2].ref[lx]) * 4
        return pblk[y * 2].mv[3 - y * 2][lx], idx, avail | 4
    if sub_kind == 2:  # 4x8, sub = x
        x = sub
        if blk_idx == 0:
            if avail & 2:
                idx = int(ref_idx == top.ref[x][lx]) * 4
                return top.mov[x + 1][lx], idx, avail | 4
            avail &= ~4
            if x == 0 and (avail & 8):
                idx = int(ref_idx == dec.lefttop_ref[lx]) * 4
                return dec.lefttop_mv[lx], idx, avail
            return ZMV, 0, avail
        if blk_idx == 1:
            if x == 0:
                if avail & 2:
                    idx = int(ref_idx == top.ref[1][lx]) * 4
                    return top.mov[3][lx], idx, avail | 4
                return ZMV, 0, avail & ~4
            if avail & 4:
                idx = int(ref_idx == topr.ref[0][lx]) * 4
                return topr.mov[0][lx], idx, avail
            if avail & 2:
                idx = int(ref_idx == top.ref[1][lx]) * 4
                mvc = top.mov[2][lx] if top.ref[1][lx] >= 0 else ZMV
                return mvc, idx, avail
            return ZMV, 0, avail
        if blk_idx == 2:
            idx = int(ref_idx == pblk[x].ref[lx]) * 4
            return pblk[x].mv[3 - x][lx], idx, avail | 4
        idx = int(ref_idx == pblk[1].ref[lx]) * 4
        return pblk[1].mv[3 - x][lx], idx, avail | 4
    # sub_kind == 3: 4x4, sub = xy
    xy = sub
    if blk_idx == 0:
        if xy == 0:
            if avail & 2:
                idx = int(ref_idx == top.ref[0][lx]) * 4
                return top.mov[1][lx], idx, avail | 4
            if avail & 8:
                idx = int(ref_idx == dec.lefttop_ref[lx]) * 4
                return dec.lefttop_mv[lx], idx, avail & ~4
            return ZMV, 0, avail & ~4
        if xy == 1:
            if avail & 2:
                idx = int(ref_idx == top.ref[1][lx]) * 4
                return top.mov[2][lx], idx, avail | 4
            return ZMV, 0, avail & ~4
        return pblk[blk_idx].mv[3 - xy][lx], 4, avail | 4
    if blk_idx == 1:
        if xy == 0:
            if avail & 2:
                idx = int(ref_idx == top.ref[1][lx]) * 4
                return top.mov[3][lx], idx, avail | 4
            return ZMV, 0, avail & ~4
        if xy == 1:
            if avail & 4:
                idx = int(ref_idx == topr.ref[0][lx]) * 4
                return topr.mov[0][lx], idx, avail
            if avail & 2:
                idx = int(ref_idx == top.ref[1][lx]) * 4
                return top.mov[2][lx], idx, avail | 4
            return ZMV, 0, avail
        return pblk[blk_idx].mv[3 - xy][lx], 4, avail | 4
    if blk_idx == 2:
        if xy in (0, 1):
            idx = int(ref_idx == pblk[xy].ref[lx]) * 4
            return pblk[xy].mv[3 - xy][lx], idx, avail | 4
        return pblk[2].mv[3 - xy][lx], 4, avail | 4
    if xy in (0, 1):
        idx = int(ref_idx == pblk[1].ref[lx]) * 4
        return pblk[1].mv[3 - xy][lx], idx, avail | 4
    return pblk[3].mv[3 - xy][lx], 4, avail | 4


# ---------------------------------------------------------------------
# deblock strength recording (inter)
# ---------------------------------------------------------------------
def _dif4(a, b):
    return 16 <= (a - b) * (a - b)


def frame_idx_of_ref(dec, ref_idx, lx):
    return dec.refs[lx][ref_idx].frame_idx if ref_idx >= 0 else -1


def str_previous_coef(map_, prev4x4):
    """h264.cpp:7119-7130: set bS=2 bits where the neighbor nC nibble != 0.
    prev4x4 here is a list of 4 nC values (the packed nibble equivalent)."""
    for i in range(4):
        if prev4x4[i]:
            map_ |= 2 << (i * 2)
    return map_


def _str_or_mask(str_, mask):
    """str |= ((str >> 1) ^ m) & m — set bS=1 where bS=2 not already set."""
    return str_ | (((str_ >> 1) ^ mask) & mask)


def str_mv_calc16x16(dec, str_, mvs, mvds, ref_idx, prev):
    """h264.cpp:7240-7259. mvs: [2][2] current MB mvs (both lists)."""
    ref0 = frame_idx_of_ref(dec, ref_idx[0], 0)
    ref1 = frame_idx_of_ref(dec, ref_idx[1], 1)
    mask = 0xA
    for i in range(2):
        if (str_ & mask) != mask:
            prev0 = int(prev.frmidx[i][0])
            prev1 = int(prev.frmidx[i][1])
            if ((prev0 != ref0 or prev1 != ref1)
                    and (prev1 != ref0 or prev0 != ref1)):
                m = mask >> 1
                str_ |= ((str_ >> 1) ^ m) & m
            else:
                str_ = _str_mv16x16_mv(str_, ref0, ref1, prev0, i * 2, mvs, prev)
        mask <<= 4
    return str_


def _str_mv16x16_mv(str_, ref0, ref1, prev_ref0, offset, mvs, prev):
    """str_mv_calc16x16_mv<0> (h264.cpp:7230-7238); MV_STEP=0 means the same
    current mv applies at both positions."""
    if ref0 >= 0 and ref1 >= 0:
        if ref0 == ref1:
            for j in range(2):
                mask = 2 << ((j + offset) * 2)
                if not str_ & mask:
                    p0 = prev.mov[j + offset][0]
                    p1 = prev.mov[j + offset][1]
                    c0, c1 = mvs[0], mvs[1]
                    if ((_dif4(c0[0], p0[0]) or _dif4(c0[1], p0[1])
                         or _dif4(c1[0], p1[0]) or _dif4(c1[1], p1[1]))
                        and (_dif4(c0[0], p1[0]) or _dif4(c0[1], p1[1])
                             or _dif4(c1[0], p0[0]) or _dif4(c1[1], p0[1]))):
                        str_ |= mask >> 1
        else:
            lx0 = int(ref0 != prev_ref0)
            lx1 = lx0 ^ 1
            for j in range(2):
                mask = 2 << ((j + offset) * 2)
                if not str_ & mask:
                    p = prev.mov[j + offset]
                    if (_dif4(mvs[lx0][0], p[0][0]) or _dif4(mvs[lx0][1], p[0][1])
                            or _dif4(mvs[lx1][0], p[1][0])
                            or _dif4(mvs[lx1][1], p[1][1])):
                        str_ |= mask >> 1
    else:
        if ref0 >= 0:
            lx_curr, lx_prev = 0, int(ref0 != prev_ref0)
        else:
            lx_curr, lx_prev = 1, int(ref1 != prev_ref0)
        for j in range(2):
            mask = 2 << ((j + offset) * 2)
            if not str_ & mask:
                p = prev.mov[j + offset][lx_prev]
                if _dif4(mvs[lx_curr][0], p[0]) or _dif4(mvs[lx_curr][1], p[1]):
                    str_ |= mask >> 1
    return str_


MB_IPCM_ = 25


def store_str_inter16xedge(dec, prev, mvs, ref_idx, str_, coeff4x4):
    """store_str_inter16xedge (h264.cpp:7261-7270). Returns (str, str4)."""
    if prev.type <= MB_IPCM_:
        return str_ | 0xAA, 1
    str_ = str_previous_coef(str_, coeff4x4)
    str_ = str_mv_calc16x16(dec, str_, mvs, None, ref_idx, prev)
    return str_, 0



def str_mv_calc16x8_left(dec, str_, ref_idx_pairs, mv_sets, prev, mv_step):
    """str_mv_calc16x8_left (h264.cpp:7451-7473): left/top MB edge when the
    current MB is split in two along the edge. ref_idx_pairs: [(r0,r1)] * 2
    per half; mv_sets: [set0, set1] each [2][2]."""
    for i in range(2):
        mask = 0xA << (i * 4)
        if (str_ & mask) != mask:
            prev0 = int(prev.frmidx[i][0])
            prev1 = int(prev.frmidx[i][1])
            ref0 = frame_idx_of_ref(dec, ref_idx_pairs[i][0], 0)
            ref1 = frame_idx_of_ref(dec, ref_idx_pairs[i][1], 1)
            if ((prev0 != ref0 or prev1 != ref1)
                    and (prev1 != ref0 or prev0 != ref1)):
                m = mask >> 1
                str_ |= ((str_ >> 1) ^ m) & m
            else:
                # MV_STEP=0 within a half: same mv at both positions
                str_ = _str_mv16x16_mv(str_, ref0, ref1, prev0, i * 2,
                                       mv_sets[i], prev)
    return str_


def store_str_inter8xedge(dec, prev, mv_sets, ref_idx_pairs, str_, coeff4x4):
    """store_str_inter8xedge (h264.cpp:7546-7556). Returns (str, str4)."""
    if prev.type <= MB_IPCM_:
        return str_ | 0xAA, 1
    str_ = str_previous_coef(str_, coeff4x4)
    str_ = str_mv_calc16x8_left(dec, str_, ref_idx_pairs, mv_sets, prev, 1)
    return str_, 0


def str_mv_calc16x8_vert(dec, str_, ref_idx4, mv_sets):
    """str_mv_calc16x8_vert (h264.cpp:7503-7518): the center edge between
    the two halves of a 16x8/8x16 MB. ref_idx4: [r00,r01,r10,r11]."""
    if (str_ & 0xAA0000) == 0xAA0000:
        return str_
    top_ref0 = frame_idx_of_ref(dec, ref_idx4[0], 0)
    top_ref1 = frame_idx_of_ref(dec, ref_idx4[1], 1)
    bot_ref0 = frame_idx_of_ref(dec, ref_idx4[2], 0)
    bot_ref1 = frame_idx_of_ref(dec, ref_idx4[3], 1)
    diff = ((top_ref0 != bot_ref0 or top_ref1 != bot_ref1)
            and (top_ref1 != bot_ref0 or top_ref0 != bot_ref1))
    if not diff:
        if top_ref0 >= 0 and top_ref1 >= 0:
            # bidir center compare (h264.cpp:7476-7493)
            if top_ref0 == bot_ref0:
                t0, t1 = mv_sets[0][0], mv_sets[0][1]
            else:
                t1, t0 = mv_sets[0][0], mv_sets[0][1]
            b0, b1 = mv_sets[1][0], mv_sets[1][1]
            diff = (_dif4(t0[0], b0[0]) or _dif4(t1[0], b1[0])
                    or _dif4(t0[1], b0[1]) or _dif4(t1[1], b1[1]))
        else:
            t = mv_sets[0][int(top_ref0 < 0)]
            b = mv_sets[1][int(bot_ref0 < 0)]
            diff = _dif4(t[0], b[0]) or _dif4(t[1], b[1])
    if diff:
        mask = 0x550000
        str_ |= ((str_ >> 1) ^ mask) & mask
    return str_


def str_mv_calc8x8_edge(dec, str_, pblk, prev, n):
    """str_mv_calc8x8_edge<N> (h264.cpp:8843-8862). n=1 top edge, 2 left."""
    for i in range(2):
        mask = 0xA << (i * 4)
        if (str_ & mask) != mask:
            p = pblk[i * n]
            prev0 = int(prev.frmidx[i][0])
            prev1 = int(prev.frmidx[i][1])
            ref0 = frame_idx_of_ref(dec, p.ref[0], 0)
            ref1 = frame_idx_of_ref(dec, p.ref[1], 1)
            if ((prev0 != ref0 or prev1 != ref1)
                    and (prev1 != ref0 or prev0 != ref1)):
                m = mask >> 1
                str_ |= ((str_ >> 1) ^ m) & m
            elif ref0 >= 0 and ref1 >= 0:
                lx = int(ref0 != prev0)
                for j in range(2):
                    bit = 2 << ((j + i * 2) * 2)
                    if not str_ & bit:
                        cm0 = p.mv[j * n][lx]
                        cm1 = p.mv[j * n][lx ^ 1]
                        pm0 = prev.mov[j + i * 2][0]
                        pm1 = prev.mov[j + i * 2][1]
                        if (_dif4(cm0[0], pm0[0]) or _dif4(cm0[1], pm0[1])
                                or _dif4(cm1[0], pm1[0]) or _dif4(cm1[1], pm1[1])):
                            str_ |= bit >> 1
            else:
                if ref0 >= 0:
                    lx_s, lx_d = 0, int(ref0 != prev0)
                else:
                    lx_s, lx_d = 1, int(ref1 != prev0)
                for j in range(2):
                    bit = 2 << ((j + i * 2) * 2)
                    if not str_ & bit:
                        cm = p.mv[j * n][lx_s]
                        pm = prev.mov[j + i * 2][lx_d]
                        if _dif4(cm[0], pm[0]) or _dif4(cm[1], pm[1]):
                            str_ |= bit >> 1
    return str_


def str_mv_calc8x8_inner_blk(dec, str_, pblk, n):
    """str_mv_calc8x8_inner<N> (h264.cpp:8994-9021). n=1 vert, 2 horiz.

    Edge groups: offset 4..7 (quarter line within first 8x8 row/col),
    8..11 (center), 12..15 (quarter line within second half)."""
    def mv_mid(str_, p, offset):
        ref0 = frame_idx_of_ref(dec, p.ref[0], 0)
        ref1 = frame_idx_of_ref(dec, p.ref[1], 1)
        for j in range(2):
            bit = 2 << ((j + offset) * 2)
            if str_ & bit:
                continue
            a = p.mv[j * n]
            b = p.mv[j * n + (3 - n)]
            if ref0 >= 0 and ref1 >= 0:
                if ref0 == ref1:
                    d = ((_dif4(a[0][0], b[0][0]) or _dif4(a[0][1], b[0][1])
                          or _dif4(a[1][0], b[1][0]) or _dif4(a[1][1], b[1][1]))
                         and (_dif4(a[0][0], b[1][0]) or _dif4(a[0][1], b[1][1])
                              or _dif4(a[1][0], b[0][0]) or _dif4(a[1][1], b[0][1])))
                else:
                    d = (_dif4(a[0][0], b[0][0]) or _dif4(a[0][1], b[0][1])
                         or _dif4(a[1][0], b[1][0]) or _dif4(a[1][1], b[1][1]))
            else:
                lx = int(ref1 >= 0)
                d = _dif4(a[lx][0], b[lx][0]) or _dif4(a[lx][1], b[lx][1])
            if d:
                str_ |= bit >> 1
        return str_

    for i in range(2):
        mask = 0xA00 << (i * 4)
        if (str_ & mask) != mask:
            str_ = mv_mid(str_, pblk[i * n], i * 2 + 4)
    for i in range(2):
        mask = 0xA0000 << (i * 4)
        if (str_ & mask) != mask:
            # half edge: between pblk[i*n] and pblk[i*n + (3-n)]
            p0 = pblk[i * n]
            p1 = pblk[i * n + (3 - n)]
            prev0 = frame_idx_of_ref(dec, p0.ref[0], 0)
            prev1 = frame_idx_of_ref(dec, p0.ref[1], 1)
            ref0 = frame_idx_of_ref(dec, p1.ref[0], 0)
            ref1 = frame_idx_of_ref(dec, p1.ref[1], 1)
            offset = i * 2 + 8
            if ((prev0 != ref0 or prev1 != ref1)
                    and (prev1 != ref0 or prev0 != ref1)):
                m = 5 << (offset * 2)
                str_ |= ((str_ >> 1) ^ m) & m
            elif ref0 >= 0 and ref1 >= 0:
                lx = int(ref0 != prev0)
                for j in range(2):
                    bit = 2 << ((j + offset) * 2)
                    if not str_ & bit:
                        mv0 = p0.mv[j * n + (3 - n)][0]
                        mv1a = p1.mv[j * n][lx]
                        mv1b = p1.mv[j * n][lx ^ 1]
                        if (_dif4(mv0[0], mv1a[0]) or _dif4(mv0[1], mv1a[1])
                                or _dif4(p0.mv[j * n + (3 - n)][1][0], mv1b[0])
                                or _dif4(p0.mv[j * n + (3 - n)][1][1], mv1b[1])):
                            str_ |= bit >> 1
            else:
                if ref0 >= 0:
                    lx_d, lx_s = 0, int(ref0 != prev0)
                else:
                    lx_d, lx_s = 1, int(ref1 != prev0)
                for j in range(2):
                    bit = 2 << ((j + offset) * 2)
                    if not str_ & bit:
                        mv0 = p0.mv[j * n + (3 - n)][lx_s]
                        mv1 = p1.mv[j * n][lx_d]
                        if _dif4(mv0[0], mv1[0]) or _dif4(mv0[1], mv1[1]):
                            str_ |= bit >> 1
    for i in range(2):
        mask = 0xA000000 << (i * 4)
        if (str_ & mask) != mask:
            str_ = mv_mid(str_, pblk[i * n + (3 - n)], i * 2 + 12)
    return str_


# ---------------------------------------------------------------------
# store_info (neighbor caches + colocated motion)
# ---------------------------------------------------------------------
class Prev8x8:
    """prev8x8_t (h264.h:350-354)."""

    __slots__ = ("ref", "mv", "mvd")

    def __init__(self):
        self.ref = np.full(2, -1, np.int32)
        self.mv = np.zeros((4, 2, 2), np.int32)
        self.mvd = np.zeros((4, 2, 2), np.int32)


def _deb_qp(dec):
    deb = dec.deblock[dec.mb_pos]
    deb.qpy = dec.qp
    deb.qpc = (dec.qp_chroma[0], dec.qp_chroma[1])
    return deb


def store_info_inter16x16(dec, mvs, mvds, ref_idx, left4x4, top4x4):
    """h264.cpp:7272-7322."""
    deb = _deb_qp(dec)
    if dec.mb_y != 0:
        deb.str_vert, s4 = store_str_inter16xedge(
            dec, dec._top(), mvs, ref_idx, deb.str_vert, top4x4)
        if s4:
            deb.str4_vert = 1
    if dec.mb_x != 0:
        deb.str_horiz, s4 = store_str_inter16xedge(
            dec, dec.mbleft, mvs, ref_idx, deb.str_horiz, left4x4)
        if s4:
            deb.str4_horiz = 1
    dec.top_pred[dec.mb_x][:] = [2] * 4
    dec.left_pred[:] = [2] * 4
    t, l = dec._top(), dec.mbleft
    t.direct8x8 = l.direct8x8 = 0
    for i in range(2):
        dec.lefttop_ref[i] = int(t.ref[1][i])
        dec.lefttop_mv[i] = t.mov[3][i]
        ref = int(ref_idx[i])
        frm = frame_idx_of_ref(dec, ref, i)
        for j in range(2):
            t.ref[j][i] = ref
            t.frmidx[j][i] = frm
            l.ref[j][i] = ref
            l.frmidx[j][i] = frm
    for i in range(4):
        for lx in range(2):
            l.mov[i][lx] = mvs[lx]
            l.mvd[i][lx] = mvds[lx]
            t.mov[i][lx] = mvs[lx]
            t.mvd[i][lx] = mvds[lx]
    # colocated page (COL_MB16x16)
    cc = dec.curr_col
    if ref_idx[0] >= 0:
        refcol, mvcol = int(ref_idx[0]), mvs[0]
    else:
        refcol, mvcol = int(ref_idx[1]), mvs[1]
    cc["type"][dec.mb_pos] = 0
    cc["ref"][dec.mb_pos] = refcol
    cc["mv"][dec.mb_pos] = mvcol


def store_info_inter16x8(dec, mv_sets, mvd_sets, ref_idx, left4x4, top4x4):
    """h264.cpp:7558-7604. mv_sets/mvd_sets: [2 halves][2 lists][2]."""
    deb = _deb_qp(dec)
    pairs = [(int(ref_idx[0]), int(ref_idx[1])), (int(ref_idx[2]), int(ref_idx[3]))]
    if dec.mb_y != 0:
        deb.str_vert, s4 = store_str_inter16xedge(
            dec, dec._top(), mv_sets[0], ref_idx[:2], deb.str_vert, top4x4)
        if s4:
            deb.str4_vert = 1
    deb.str_vert = str_mv_calc16x8_vert(dec, deb.str_vert, ref_idx, mv_sets)
    if dec.mb_x != 0:
        deb.str_horiz, s4 = store_str_inter8xedge(
            dec, dec.mbleft, mv_sets, pairs, deb.str_horiz, left4x4)
        if s4:
            deb.str4_horiz = 1
    dec.left_pred[:] = [2] * 4
    dec.top_pred[dec.mb_x][:] = [2] * 4
    t, l = dec._top(), dec.mbleft
    dec.lefttop_ref[0] = int(t.ref[1][0])
    dec.lefttop_ref[1] = int(t.ref[1][1])
    dec.lefttop_mv[0] = t.mov[3][0]
    dec.lefttop_mv[1] = t.mov[3][1]
    l.direct8x8 = t.direct8x8 = 0
    for i in range(4):
        for lx in range(2):
            t.mov[i][lx] = mv_sets[1][lx]
            t.mvd[i][lx] = mvd_sets[1][lx]
    r2, r3 = pairs[1]
    f2 = frame_idx_of_ref(dec, r2, 0)
    f3 = frame_idx_of_ref(dec, r3, 1)
    for i in range(2):
        t.ref[i][0] = r2
        t.ref[i][1] = r3
        t.frmidx[i][0] = f2
        t.frmidx[i][1] = f3
        for lx in range(2):
            l.mov[i][lx] = mv_sets[0][lx]
            l.mvd[i][lx] = mvd_sets[0][lx]
            l.mov[2 + i][lx] = mv_sets[1][lx]
            l.mvd[2 + i][lx] = mvd_sets[1][lx]
        l.ref[0][i] = int(ref_idx[i])
        l.frmidx[0][i] = frame_idx_of_ref(dec, int(ref_idx[i]), i)
    l.ref[1][0] = r2
    l.ref[1][1] = r3
    l.frmidx[1][0] = f2
    l.frmidx[1][1] = f3
    # col (COL_MB16x8)
    cc = dec.curr_col
    cc["type"][dec.mb_pos] = 1
    for y in range(2):
        if pairs[y][0] >= 0:
            refcol, mvcol = pairs[y][0], mv_sets[y][0]
        else:
            refcol, mvcol = pairs[y][1], mv_sets[y][1]
        cc["ref"][dec.mb_pos][y * 2 : y * 2 + 2] = refcol
        cc["mv"][dec.mb_pos][y * 8 : y * 8 + 8] = mvcol


def store_info_inter8x16(dec, mv_sets, mvd_sets, ref_idx, left4x4, top4x4):
    """h264.cpp:7776-7821."""
    deb = _deb_qp(dec)
    pairs = [(int(ref_idx[0]), int(ref_idx[1])), (int(ref_idx[2]), int(ref_idx[3]))]
    if dec.mb_y != 0:
        deb.str_vert, s4 = store_str_inter8xedge(
            dec, dec._top(), mv_sets, pairs, deb.str_vert, top4x4)
        if s4:
            deb.str4_vert = 1
    if dec.mb_x != 0:
        deb.str_horiz, s4 = store_str_inter16xedge(
            dec, dec.mbleft, mv_sets[0], ref_idx[:2], deb.str_horiz, left4x4)
        if s4:
            deb.str4_horiz = 1
    deb.str_horiz = str_mv_calc16x8_vert(dec, deb.str_horiz, ref_idx, mv_sets)
    dec.left_pred[:] = [2] * 4
    dec.top_pred[dec.mb_x][:] = [2] * 4
    t, l = dec._top(), dec.mbleft
    l.direct8x8 = t.direct8x8 = 0
    r2, r3 = pairs[1]
    f2 = frame_idx_of_ref(dec, r2, 0)
    f3 = frame_idx_of_ref(dec, r3, 1)
    new_lefttop_ref = [int(t.ref[1][0]), int(t.ref[1][1])]
    new_lefttop_mv = [t.mov[3][0].copy(), t.mov[3][1].copy()]
    for i in range(2):
        dec.lefttop_ref[i] = new_lefttop_ref[i]
        l.ref[i][0] = r2
        l.ref[i][1] = r3
        l.frmidx[i][0] = f2
        l.frmidx[i][1] = f3
        t.ref[0][i] = int(ref_idx[i])
        t.frmidx[0][i] = frame_idx_of_ref(dec, int(ref_idx[i]), i)
        dec.lefttop_mv[i] = new_lefttop_mv[i]
        for lx in range(2):
            t.mov[i][lx] = mv_sets[0][lx]
            t.mvd[i][lx] = mvd_sets[0][lx]
            t.mov[i + 2][lx] = mv_sets[1][lx]
            t.mvd[i + 2][lx] = mvd_sets[1][lx]
    t.ref[1][0] = r2
    t.ref[1][1] = r3
    t.frmidx[1][0] = f2
    t.frmidx[1][1] = f3
    for i in range(4):
        for lx in range(2):
            l.mov[i][lx] = mv_sets[1][lx]
            l.mvd[i][lx] = mvd_sets[1][lx]
    # col (COL_MB8x16)
    cc = dec.curr_col
    cc["type"][dec.mb_pos] = 2
    for x in range(2):
        if pairs[x][0] >= 0:
            refcol, mvcol = pairs[x][0], mv_sets[x][0]
        else:
            refcol, mvcol = pairs[x][1], mv_sets[x][1]
        cc["ref"][dec.mb_pos][x] = refcol
        cc["ref"][dec.mb_pos][x + 2] = refcol
        for row in range(4):
            cc["mv"][dec.mb_pos][row * 4 + x * 2] = mvcol
            cc["mv"][dec.mb_pos][row * 4 + x * 2 + 1] = mvcol


def store_info_intermb8x8(dec, pblk, left4x4, top4x4):
    """h264.cpp:9023-9077 + store_col8x8 (:9079-9102)."""
    deb = _deb_qp(dec)
    if dec.mb_y != 0:
        if dec._top().type <= MB_IPCM_:
            deb.str4_vert = 1
            deb.str_vert |= 0xAA
        else:
            deb.str_vert = str_mv_calc8x8_edge(
                dec, str_previous_coef(deb.str_vert, top4x4), pblk,
                dec._top(), 1)
    deb.str_vert = str_mv_calc8x8_inner_blk(dec, deb.str_vert, pblk, 1)
    if dec.mb_x != 0:
        if dec.mbleft.type <= MB_IPCM_:
            deb.str4_horiz = 1
            deb.str_horiz |= 0xAA
        else:
            deb.str_horiz = str_mv_calc8x8_edge(
                dec, str_previous_coef(deb.str_horiz, left4x4), pblk,
                dec.mbleft, 2)
    deb.str_horiz = str_mv_calc8x8_inner_blk(dec, deb.str_horiz, pblk, 2)
    dec.left_pred[:] = [2] * 4
    dec.top_pred[dec.mb_x][:] = [2] * 4
    t, l = dec._top(), dec.mbleft
    for i in range(2):
        dec.lefttop_mv[i] = t.mov[3][i]
        dec.lefttop_ref[i] = int(t.ref[1][i])
        t.mov[0][i] = pblk[2].mv[2][i]
        t.mov[1][i] = pblk[2].mv[3][i]
        t.mov[2][i] = pblk[3].mv[2][i]
        t.mov[3][i] = pblk[3].mv[3][i]
        t.mvd[0][i] = pblk[2].mvd[2][i]
        t.mvd[1][i] = pblk[2].mvd[3][i]
        t.mvd[2][i] = pblk[3].mvd[2][i]
        t.mvd[3][i] = pblk[3].mvd[3][i]
        l.ref[0][i] = int(pblk[1].ref[i])
        l.frmidx[0][i] = frame_idx_of_ref(dec, int(pblk[1].ref[i]), i)
        l.ref[1][i] = int(pblk[3].ref[i])
        l.frmidx[1][i] = frame_idx_of_ref(dec, int(pblk[3].ref[i]), i)
        t.ref[0][i] = int(pblk[2].ref[i])
        t.frmidx[0][i] = frame_idx_of_ref(dec, int(pblk[2].ref[i]), i)
        t.ref[1][i] = int(pblk[3].ref[i])
        t.frmidx[1][i] = frame_idx_of_ref(dec, int(pblk[3].ref[i]), i)
    for i in range(4):
        p = pblk[(i & 2) + 1]
        idx = (i & 1) * 2 + 1
        for j in range(2):
            l.mov[i][j] = p.mv[idx][j]
            l.mvd[i][j] = p.mvd[idx][j]
    # col (COL_MB8x8)
    cc = dec.curr_col
    cc["type"][dec.mb_pos] = 3
    mvdst = cc["mv"][dec.mb_pos]
    base = 0
    for blk in range(4):
        refcol = int(pblk[blk].ref[0])
        lx = 0
        if refcol < 0:
            lx = 1
            refcol = int(pblk[blk].ref[1])
        cc["ref"][dec.mb_pos][blk] = refcol
        # store_col8x8 (h264.cpp:9079-9102): mvcol walks the flattened
        # h264d_vector_t mv[4][2] array starting at list lx
        flat = pblk[blk].mv.reshape(8, 2)
        mvdst[base + 0] = flat[0 + lx]
        mvdst[base + 1] = flat[2 + lx]
        mvdst[base + 4] = flat[4 + lx]
        mvdst[base + 5] = flat[6 + lx]
        base += 6 if blk & 1 else 2
