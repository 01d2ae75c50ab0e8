"""H.264 B-direct and B-skip prediction (spatial + temporal).

Behavioral mirror of the reference (reference: src/lib/h264.cpp):
* spatial direct: neighbor min-ref + median MV (b_skip_ref_mv :8325-8351,
  b_direct_ref_mv_calc :8353-8387), colocated-zeroing per col-MB partition
  granularity (pred_direct16x16 :9954-9979, col dispatch :9790-9952);
* temporal direct: map_col_to_list0 + dist scale (create_map_col_to_list0
  :1259-1267, temporal_direct_block :10027-10126);
* B-skip (b_skip_mb_spatial :9981-9990, b_skip_mb_temporal :10114-10126).

`msets` ([16][2][2]) reproduces the reference's h264d_vector_set_t mv[16]
layout (set indices as used by the col dispatch).

direct_8x8_inference_flag is REQUIRED to be 1: the reference's
BLOCK==4 temporal-zero path walks past the end of its 2-entry zero_mov
array (h264.cpp:10034-10039 with zero_mov), i.e. is UB; real streams set
the flag, and the decoder rejects the rest.
"""

from __future__ import annotations

import numpy as np

from . import inter as I

COL_MB16x16, COL_MB16x8, COL_MB8x16, COL_MB8x8 = 0, 1, 2, 3
SHORT_TERM, LONG_TERM = 1, 2


def b_skip_ref_mv(dec, avail):
    """b_direct_ref_mv_calc (h264.cpp:8353-8387): returns (ref2, mv2x2)."""
    non_ref = np.full(4, -1, np.int32)
    zero2 = np.zeros((2, 2), np.int32)
    if avail & 1:
        ref_a, mv_a = dec.mbleft.ref[0], dec.mbleft.mov[0]
    else:
        ref_a, mv_a = non_ref, zero2
    if avail & 2:
        ref_b, mv_b = dec._top().ref[0], dec._top().mov[0]
    else:
        ref_b, mv_b = non_ref, zero2
    if avail & 4:
        ref_c, mv_c = dec._topright().ref[0], dec._topright().mov[0]
    elif avail & 8:
        ref_c, mv_c = dec.lefttop_ref, dec.lefttop_mv
    else:
        ref_c, mv_c = non_ref, zero2
    ref_out = np.zeros(2, np.int32)
    mv_out = np.zeros((2, 2), np.int32)
    for lx in range(2):
        ra, rb, rc = int(ref_a[lx]), int(ref_b[lx]), int(ref_c[lx])
        # unsigned MIN (h264.cpp:8331-8332): negatives sort last
        cand = min(ra & 0xFFFFFFFF, rb & 0xFFFFFFFF, rc & 0xFFFFFFFF)
        ref = cand - (1 << 32) if cand >= 1 << 31 else cand
        if ref < 0:
            mv_out[lx] = 0
        elif ra == ref and rb != ref and rc != ref:
            mv_out[lx] = mv_a[lx]
        elif ra != ref and rb == ref and rc != ref:
            mv_out[lx] = mv_b[lx]
        elif ra != ref and rb != ref and rc == ref:
            mv_out[lx] = mv_c[lx]
        else:
            mv_out[lx] = (
                I.median(int(mv_a[lx][0]), int(mv_b[lx][0]), int(mv_c[lx][0])),
                I.median(int(mv_a[lx][1]), int(mv_b[lx][1]), int(mv_c[lx][1])),
            )
        ref_out[lx] = ref
    return ref_out, mv_out


def _mvcol_small(mv):
    return abs(int(mv[0])) <= 1 and abs(int(mv[1])) <= 1


def _col_zero_pred(dec, refs_mask, mvcol, msets, set_idx, ref_idx, bw, bh,
                   ox, oy):
    """pred_direct_col_block_{bidir,onedir}<.., 16, X, Y>
    (h264.cpp:8394-8430 with N=16: single-set zeroing)."""
    cur = msets[set_idx]
    if refs_mask == 3:
        if (cur[0].any() or cur[1].any()) and _mvcol_small(mvcol):
            cur[:] = 0
            I.inter_pred_basic(dec, [0, 0], cur, bw, bh, ox, oy)
        else:
            I.inter_pred_basic(dec, ref_idx, cur, bw, bh, ox, oy)
    else:
        lx = 0 if refs_mask == 1 else 1
        if cur[lx].any() and _mvcol_small(mvcol):
            cur[lx] = 0
        I.inter_pred_basic(dec, ref_idx, cur, bw, bh, ox, oy)


def pred_direct16x16(dec, ref_idx2, msets):
    """pred_direct16x16 (h264.cpp:9954-9979); ref_idx2 mutated."""
    colpic = dec.refs[1][0]
    page = colpic.col
    pos = dec.mb_pos
    if ref_idx2[0] < 0 and ref_idx2[1] < 0:
        ref_idx2[0] = 0
        ref_idx2[1] = 0
        page["type"][pos] = COL_MB16x16
        msets[1] = 0
        I.inter_pred_basic(dec, ref_idx2, msets[0], 16, 16, 0, 0)
        return
    if colpic.in_use != SHORT_TERM:
        page["type"][pos] = COL_MB16x16
        msets[1] = 0
        I.inter_pred_basic(dec, ref_idx2, msets[0], 16, 16, 0, 0)
        return
    refs_mask = int(ref_idx2[0] == 0) + int(ref_idx2[1] == 0) * 2
    col_type = int(page["type"][pos])
    colmv = page["mv"][pos]
    colref = page["ref"][pos]
    if refs_mask == 0:
        # direct_mv_pred_nocol (h264.cpp:9782-9788): 16x16 with current mv,
        # col type forced, sets 2,3 (vector units) cleared
        I.inter_pred_basic(dec, ref_idx2, msets[0], 16, 16, 0, 0)
        page["type"][pos] = COL_MB16x16
        msets[1] = 0
        return
    if col_type == COL_MB16x16:
        if colref[0] == 0:
            _col_zero_pred(dec, refs_mask, colmv[0], msets, 0, ref_idx2,
                           16, 16, 0, 0)
        else:
            I.inter_pred_basic(dec, ref_idx2, msets[0], 16, 16, 0, 0)
        msets[1] = 0
    elif col_type == COL_MB16x8:
        msets[1] = msets[0]
        for y in range(2):
            if colref[y * 2] == 0:
                _col_zero_pred(dec, refs_mask, colmv[y * 8], msets, y,
                               ref_idx2, 16, 8, 0, y * 8)
            else:
                I.inter_pred_basic(dec, ref_idx2, msets[y], 16, 8, 0, y * 8)
        msets[2] = 0
        msets[3] = 0
    elif col_type == COL_MB8x16:
        msets[1] = msets[0]
        for x in range(2):
            if colref[x] == 0:
                _col_zero_pred(dec, refs_mask, colmv[x * 2], msets, x,
                               ref_idx2, 8, 16, x * 8, 0)
            else:
                I.inter_pred_basic(dec, ref_idx2, msets[x], 8, 16, x * 8, 0)
        msets[2] = 0
        msets[3] = 0
    else:  # COL_MB8x8 (direct_8x8_inference=1 -> corner-mv, one set/quad)
        for k in range(1, 4):
            msets[k] = msets[0]
        for blk in range(4):
            ox, oy = (blk & 1) * 8, (blk & 2) * 4
            if colref[blk] == 0:
                mvi = (blk & 2) * 6 + (blk & 1) * 3
                _col_zero_pred(dec, refs_mask, colmv[mvi], msets, blk,
                               ref_idx2, 8, 8, ox, oy)
            else:
                I.inter_pred_basic(dec, ref_idx2, msets[blk], 8, 8, ox, oy)


def b_skip_mb_spatial(dec, ref_idx8, msets):
    """b_skip_mb_spatial (h264.cpp:9981-9990): quadrant refs are copied
    BEFORE pred_direct16x16, which may then set only ref_idx8[0..1] to 0
    (both-negative case) — the copies keep their value."""
    avail = dec._avail()
    ref2, mv2 = b_skip_ref_mv(dec, avail)
    msets[0] = mv2
    for i in range(4):
        ref_idx8[i * 2] = ref2[0]
        ref_idx8[i * 2 + 1] = ref2[1]
    rr = ref_idx8[:2]  # view: pred_direct16x16 mutates in place
    pred_direct16x16(dec, rr, msets)


def pred_direct8x8_spatial(dec, blk_idx, pblk, avail, shared, type0_cnt):
    """pred_direct8x8_spatial<8> (h264.cpp:8538-8546 + :8483-8524).

    shared: dict carrying the once-computed ref/mv (ref_blk)."""
    if type0_cnt == 0:
        ref2, mv2 = b_skip_ref_mv(dec, avail)
        shared["ref"] = ref2
        shared["mv"] = mv2
    p = pblk[blk_idx]
    p.ref[0] = shared["ref"][0]
    p.ref[1] = shared["ref"][1]
    for k in range(4):
        p.mv[k][0] = shared["mv"][0]
        p.mv[k][1] = shared["mv"][1]
    xoffset = (blk_idx & 1) * 8
    yoffset = (blk_idx & 2) * 4
    if p.ref[0] >= 0 or p.ref[1] >= 0:
        colpic = dec.refs[1][0]
        page = colpic.col
        pos = dec.mb_pos
        colref = page["ref"][pos]
        if colpic.in_use == SHORT_TERM and colref[blk_idx] == 0:
            refs_mask = int(p.ref[0] == 0) + int(p.ref[1] == 0) * 2
            mvi = (blk_idx & 2) * 6 + (blk_idx & 1) * 3
            mvcol = page["mv"][pos][mvi]
            if refs_mask == 0:
                I.inter_pred_basic(dec, p.ref, p.mv[0], 8, 8, xoffset, yoffset)
            elif refs_mask == 3:
                # pred_direct_col_block_bidir<8,8,8>: zero all four sub-mvs
                if (p.mv[0][0].any() or p.mv[0][1].any()) and _mvcol_small(mvcol):
                    p.mv[:] = 0
                    I.inter_pred_basic(dec, [0, 0], p.mv[0], 8, 8,
                                       xoffset, yoffset)
                else:
                    I.inter_pred_basic(dec, p.ref, p.mv[0], 8, 8,
                                       xoffset, yoffset)
            else:
                lx = 0 if refs_mask == 1 else 1
                if p.mv[0][lx].any() and _mvcol_small(mvcol):
                    for k in range(4):
                        p.mv[k][lx] = 0
                I.inter_pred_basic(dec, p.ref, p.mv[0], 8, 8, xoffset, yoffset)
        else:
            I.inter_pred_basic(dec, p.ref, p.mv[0], 8, 8, xoffset, yoffset)
    else:
        p.ref[0] = 0
        p.ref[1] = 0
        p.mv[:] = 0
        I.inter_pred_basic(dec, p.ref, p.mv[0], 8, 8, xoffset, yoffset)


# ---------------------------------------------------------------------
# temporal direct
# ---------------------------------------------------------------------
def _ctrunc_div(a, b):
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def dist_scale_factor(poc0, poc1, curr_poc):
    """h264.cpp:1247-1257 (C truncation division)."""
    if poc1 == poc0:
        return 256
    td = max(-128, min(127, poc1 - poc0))
    tb = max(-128, min(127, curr_poc - poc0))
    tx = _ctrunc_div(16384 + abs(_ctrunc_div(td, 2)), td)
    return (tb * tx + 32) >> 6


def create_map_col_to_list0(dec):
    """h264.cpp:1259-1267."""
    sps = dec.sps
    n = sps.num_ref_frames
    ref0, ref1 = dec.refs[0], dec.refs[1]
    poc1 = ref1[0].poc
    page = ref1[0].col
    mapc = (page["map_col_frameidx"] if page is not None
            else np.zeros(16, np.int32))
    map_out = np.full(16, -1, np.int32)
    scale = np.zeros(16, np.int32)
    for i in range(n):
        tgt = int(mapc[i])
        found = -1
        if tgt >= 0:
            for k in range(n):
                if ref0[k].frame_idx == tgt:
                    found = k
                    break
        map_out[i] = found
        scale[i] = max(-1024, min(1023, dist_scale_factor(
            ref0[i].poc, poc1, dec.hdr.poc)))
    dec.bdirect_map = map_out
    dec.bdirect_scale = scale


def _temporal_vector(mvcol, scale):
    t = (int(mvcol) * scale + 128) >> 8
    return t, t - int(mvcol)


def _temporal_block8(dec, blk_idx, msets_or_mv, set_idx, bw, bh, ox, oy):
    """temporal_direct_block<.., 8, X, Y> with inference (single sub).
    Returns the (ref0, 0) pair used."""
    colpic = dec.refs[1][0]
    page = colpic.col
    pos = dec.mb_pos
    colref = int(page["ref"][pos][blk_idx])
    ref = int(dec.bdirect_map[colref]) if colref >= 0 else 0
    rp = np.array([ref, 0], np.int32)
    mv = msets_or_mv[set_idx]
    if colref >= 0 and dec.refs[0][ref].in_use != LONG_TERM:
        mvi = (blk_idx & 2) * 6 + (blk_idx & 1) * 3
        mvcol = page["mv"][pos][mvi]
        scale = int(dec.bdirect_scale[ref])
        mv[0][0], mv[1][0] = _temporal_vector(mvcol[0], scale)
        mv[0][1], mv[1][1] = _temporal_vector(mvcol[1], scale)
    else:
        mv[:] = 0
    I.inter_pred_basic(dec, rp, mv, bw, bh, ox, oy)
    return rp


def b_skip_mb_temporal(dec, ref_idx8, msets):
    """b_skip_mb_temporal<1> (h264.cpp:10114-10126)."""
    page = dec.refs[1][0].col
    col_type = int(page["type"][dec.mb_pos])
    if col_type == COL_MB16x16:
        rp = _temporal_block8(dec, 0, msets, 0, 16, 16, 0, 0)
        ref_idx8[0:8:2] = rp[0]
        ref_idx8[1:8:2] = rp[1]
        msets[1] = 0
    elif col_type == COL_MB16x8:
        for y in range(2):
            rp = _temporal_block8(dec, y * 2, msets, y, 16, 8, 0, y * 8)
            ref_idx8[y * 2] = rp[0]
            ref_idx8[y * 2 + 1] = rp[1]
        ref_idx8[4:8] = ref_idx8[0:4]
        msets[2] = 0
        msets[3] = 0
    elif col_type == COL_MB8x16:
        for x in range(2):
            rp = _temporal_block8(dec, x, msets, x, 8, 16, x * 8, 0)
            ref_idx8[x * 2] = rp[0]
            ref_idx8[x * 2 + 1] = rp[1]
        ref_idx8[4:8] = ref_idx8[0:4]
        msets[2] = 0
        msets[3] = 0
    else:
        for blk in range(4):
            rp = _temporal_block8(dec, blk, msets, blk, 8, 8,
                                  (blk & 1) * 8, (blk & 2) * 4)
            ref_idx8[blk * 2] = rp[0]
            ref_idx8[blk * 2 + 1] = rp[1]


def pred_direct8x8_temporal(dec, blk_idx, pblk, avail, shared, type0_cnt):
    """pred_direct8x8_temporal (h264.cpp:10072-10081) with inference."""
    p = pblk[blk_idx]
    colpic = dec.refs[1][0]
    page = colpic.col
    pos = dec.mb_pos
    colref = int(page["ref"][pos][blk_idx])
    ref = int(dec.bdirect_map[colref]) if colref >= 0 else 0
    p.ref[0] = ref
    p.ref[1] = 0
    if colref >= 0 and dec.refs[0][ref].in_use != LONG_TERM:
        mvi = (blk_idx & 2) * 6 + (blk_idx & 1) * 3
        mvcol = page["mv"][pos][mvi]
        scale = int(dec.bdirect_scale[ref])
        l0x, l1x = _temporal_vector(mvcol[0], scale)
        l0y, l1y = _temporal_vector(mvcol[1], scale)
        for k in range(4):
            p.mv[k][0] = (l0x, l0y)
            p.mv[k][1] = (l1x, l1y)
    else:
        p.mv[:] = 0
    I.inter_pred_basic(dec, p.ref, p.mv[0], 8, 8,
                       (blk_idx & 1) * 8, (blk_idx & 2) * 4)


# ---------------------------------------------------------------------
# store for skip / direct16x16 (vector-set 8x8 layout, N=8)
# ---------------------------------------------------------------------
def _str8x8_inner_vecset(dec, str_, ref8, msets, is_horiz):
    """str_mv_calc8x8_inner<8, IS_HORIZ> (h264.cpp:9273-9302)."""
    mask_acc = 0
    for x in range(2):
        shift = x * 4
        if is_horiz:
            t0 = I.frame_idx_of_ref(dec, int(ref8[x * 4 + 0]), 0)
            t1 = I.frame_idx_of_ref(dec, int(ref8[x * 4 + 1]), 1)
            b0 = I.frame_idx_of_ref(dec, int(ref8[x * 4 + 2]), 0)
            b1 = I.frame_idx_of_ref(dec, int(ref8[x * 4 + 3]), 1)
            mv_top, mv_bot = msets[x * 2], msets[x * 2 + 1]
        else:
            t0 = I.frame_idx_of_ref(dec, int(ref8[x * 2 + 0]), 0)
            t1 = I.frame_idx_of_ref(dec, int(ref8[x * 2 + 1]), 1)
            b0 = I.frame_idx_of_ref(dec, int(ref8[x * 2 + 4]), 0)
            b1 = I.frame_idx_of_ref(dec, int(ref8[x * 2 + 5]), 1)
            mv_top, mv_bot = msets[x], msets[x + 2]
        center_mask = 0xA0000 << shift
        if (t0 != b0 or t1 != b1) and (t1 != b0 or t0 != b1):
            bits = 0x50000 << shift
        else:
            bits = 0
            if (str_ & center_mask) != center_mask:
                if t0 >= 0 and t1 >= 0:
                    lx = int(t0 != b0)
                    d = (I._dif4(int(mv_top[0][0]), int(mv_bot[lx][0]))
                         or I._dif4(int(mv_top[0][1]), int(mv_bot[lx][1]))
                         or I._dif4(int(mv_top[1][0]), int(mv_bot[lx ^ 1][0]))
                         or I._dif4(int(mv_top[1][1]), int(mv_bot[lx ^ 1][1])))
                else:
                    tlx = int(t0 < 0)
                    blx = int(b0 < 0)
                    d = (I._dif4(int(mv_top[tlx][0]), int(mv_bot[blx][0]))
                         or I._dif4(int(mv_top[tlx][1]), int(mv_bot[blx][1])))
                if d:
                    bits = (center_mask >> 1)
        mask_acc |= bits
    return str_ | (((str_ >> 1) ^ mask_acc) & mask_acc)


def store_info_inter8x8_vecset(dec, msets, ref8, left4x4, top4x4):
    """store_info_inter8x8<8> (h264.cpp:9304-9388)."""
    deb = I._deb_qp(dec)
    if dec.mb_y != 0:
        pairs = [(int(ref8[0]), int(ref8[1])), (int(ref8[2]), int(ref8[3]))]
        deb.str_vert, s4 = I.store_str_inter8xedge(
            dec, dec._top(), [msets[0], msets[1]], pairs, deb.str_vert, top4x4)
        if s4:
            deb.str4_vert = 1
    deb.str_vert = _str8x8_inner_vecset(dec, deb.str_vert, ref8, msets, False)
    if dec.mb_x != 0:
        pairs = [(int(ref8[0]), int(ref8[1])), (int(ref8[4]), int(ref8[5]))]
        deb.str_horiz, s4 = I.store_str_inter8xedge(
            dec, dec.mbleft, [msets[0], msets[2]], pairs, deb.str_horiz, left4x4)
        if s4:
            deb.str4_horiz = 1
    deb.str_horiz = _str8x8_inner_vecset(dec, deb.str_horiz, ref8, msets, True)
    dec.left_pred[:] = [2] * 4
    dec.top_pred[dec.mb_x][:] = [2] * 4
    t, l = dec._top(), dec.mbleft
    for i in range(2):
        dec.lefttop_ref[i] = int(t.ref[1][i])
        dec.lefttop_mv[i] = t.mov[3][i]
        r = int(ref8[i * 2 + 4])
        t.ref[i][0] = r
        t.frmidx[i][0] = I.frame_idx_of_ref(dec, r, 0)
        r = int(ref8[i * 2 + 5])
        t.ref[i][1] = r
        t.frmidx[i][1] = I.frame_idx_of_ref(dec, r, 1)
        r = int(ref8[i * 4 + 2])
        l.ref[i][0] = r
        l.frmidx[i][0] = I.frame_idx_of_ref(dec, r, 0)
        r = int(ref8[i * 4 + 3])
        l.ref[i][1] = r
        l.frmidx[i][1] = I.frame_idx_of_ref(dec, r, 1)
    for i in range(4):
        t.mov[i] = msets[(i >> 1) + 2]
        l.mov[i] = msets[(i >> 1) * 2 + 1]
    t.mvd[:] = 0
    l.mvd[:] = 0
    # col (COL_MB8x8) with per-quadrant uniform mv
    cc = dec.curr_col
    cc["type"][dec.mb_pos] = 3
    mvdst = cc["mv"][dec.mb_pos]
    base = 0
    for blk in range(4):
        refcol = int(ref8[blk * 2])
        lx = 0
        if refcol < 0:
            lx = 1
            refcol = int(ref8[blk * 2 + 1])
        cc["ref"][dec.mb_pos][blk] = refcol
        src = msets[blk][lx]
        mvdst[base + 0] = src
        mvdst[base + 1] = src
        mvdst[base + 4] = src
        mvdst[base + 5] = src
        base += 6 if blk & 1 else 2


def store_info_direct(dec, msets, ref8, left4x4, top4x4, col_type):
    """store_info_inter<1> dispatch (h264.cpp:9390-9400)."""
    if col_type == COL_MB16x16:
        I.store_info_inter16x16(dec, msets[0], msets[1], ref8[:2],
                                left4x4, top4x4)
    elif col_type == COL_MB16x8:
        I.store_info_inter16x8(dec, msets[0:2], msets[2:4], ref8[:4],
                               left4x4, top4x4)
    elif col_type == COL_MB8x16:
        I.store_info_inter8x16(dec, msets[0:2], msets[2:4], ref8[:4],
                               left4x4, top4x4)
    else:
        store_info_inter8x8_vecset(dec, msets, ref8, left4x4, top4x4)
