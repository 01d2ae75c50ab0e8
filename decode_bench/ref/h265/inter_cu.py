"""H.265 inter CU decode: skip/merge/AMVP prediction units
(reference pred_inter + prediction_unit*, h265.cpp:3572-4073).

Milestone scope: P slices with 2Nx2N partitions; merge candidates are
the spatial A1/B1/B0/A0/B2 set plus zero-MV padding (temporal MVP off).
AMVP follows the reference's two-spatial + zero fallback (the temporal
candidate requires slice_temporal_mvp which crashes the reference when
off at the colpics deref — see prediction_unit, h265.cpp:4030).
"""

from __future__ import annotations

from decode_bench.ref.h265 import cabac as C
from decode_bench.ref.h265 import inter as IP
from decode_bench.ref.h265.colpics import scale_mv
from decode_bench.ref.h265.ctu import PredInfo


def _i16(v):
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _merge_available(cx, cy, px, py, shift):
    return ((cx >> shift) != (px >> shift)) or ((cy >> shift)
                                                != (py >> shift))


def _add_merge_candidate(lst, cx, cy, nx, ny, par, nb):
    if not nb.pu_intra and _merge_available(cx, cy, nx, ny, par):
        for p in lst:
            if p.same(nb.pred):
                return
        lst.append(nb.pred.copy())


def _merge_zero_mv(ctu, idx, num):
    hdr = ctu.hdr
    p_slice = hdr.slice_type > 0
    if p_slice:
        nri = hdr.num_ref_idx_minus1[0] + 1
    else:
        nri = min(hdr.num_ref_idx_minus1[0],
                  hdr.num_ref_idx_minus1[1]) + 1
    m = idx - num
    ref = m if m < nri else 0
    p = PredInfo()
    p.ref_idx = [ref, -1 if p_slice else ref]
    return p


def merge_list(ctu, idx, unavail, offset_x, offset_y, width, height,
               left_arr, left_i, top_arr, top_i, lefttop):
    """prediction_unit_merge candidate derivation
    (h265.cpp:3690-3719)."""
    par = ctu.pps.log2_parallel_merge_level
    lst = []
    ox, oy = offset_x, offset_y
    if not (unavail & 1):
        _add_merge_candidate(lst, ox, oy, ox - 1, oy + height - 1, par,
                             left_arr[left_i + (height >> 2) - 1])
    if len(lst) <= idx:
        if not (unavail & 2):
            _add_merge_candidate(lst, ox, oy, ox + width - 1, oy - 1,
                                 par, top_arr[top_i + (width >> 2) - 1])
        if not (unavail & 8):
            _add_merge_candidate(lst, ox, oy, ox + width, oy - 1, par,
                                 top_arr[top_i + (width >> 2)])
        if not (unavail & 4):
            _add_merge_candidate(lst, ox, oy, ox - 1, oy + height, par,
                                 left_arr[left_i + (height >> 2)])
        if len(lst) <= idx and len(lst) < 4:
            _add_merge_candidate(lst, ox, oy, ox - 1, oy - 1, par,
                                 lefttop)
    if len(lst) <= idx and ctu.hdr.temporal_mvp:
        col = ctu.colpics.get_ref(ox, oy, width, height)
        if not col.pu_intra:
            if ctu.hdr.slice_type != 0:
                # P-slice temporal merge candidates carry uninitialized
                # stack ref_idx[1]/mvd[1] in the reference
                # (pred_info_t list[5], h265.cpp:3694) — indeterminate
                raise NotImplementedError(
                    "reference-indeterminate: P temporal merge candidate")
            p = PredInfo()
            _add_colpic_candidate(ctu, p, col, 0, 0)
            _add_colpic_candidate(ctu, p, col, 1, 0)
            lst.append(p)
    if (1 < len(lst) and len(lst) <= idx
            and ctu.hdr.slice_type == 0):
        _add_combined(ctu, lst, idx)
    while len(lst) <= idx:
        lst.append(_merge_zero_mv(ctu, idx, len(lst)))
    return lst[idx]


_L0_CAND_IDX = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)


def _add_combined(ctu, lst, idx_max):
    """add_merge_combind_candidate (h265.cpp:3660-3688)."""
    idx = len(lst)
    cutoff = idx * (idx - 1)
    for comb in range(cutoff):
        l0i = _L0_CAND_IDX[comb]
        l1i = _L0_CAND_IDX[comb ^ 1]
        if idx_max <= l0i or idx_max <= l1i:
            break
        c0 = lst[l0i]
        c1 = lst[l1i]
        if c0.ref_idx[0] >= 0 and c1.ref_idx[1] >= 0:
            if (c0.mv[0] != c1.mv[1]
                    or ctu.hdr.ref_list[0][c0.ref_idx[0]][0]
                    != ctu.hdr.ref_list[1][c1.ref_idx[1]][0]):
                p = PredInfo()
                p.mv[0] = list(c0.mv[0])
                p.mv[1] = list(c1.mv[1])
                p.ref_idx = [c0.ref_idx[0], c1.ref_idx[1]]
                lst.append(p)
                idx += 1
                if idx_max < idx:
                    break


def _add_colpic_candidate(ctu, pred, col, lx, ref_idx):
    """add_colpic_candidate (h265.cpp:3637-3650)."""
    cp = ctu.colpics
    col_lx = lx if cp.lowdelay else ctu.hdr.colocated_from_l0
    col_refidx = col.ref_idx[col_lx]
    if col_refidx < 0:
        col_lx ^= 1
        col_refidx = col.ref_idx[col_lx]
    pred.ref_idx[lx] = ref_idx
    scale = cp.colmv_scale(lx, ref_idx, col_lx, col_refidx)
    pred.mv[lx][0] = scale_mv(col.mv[col_lx][0], scale)
    pred.mv[lx][1] = scale_mv(col.mv[col_lx][1], scale)
    return True


def _mvp2nd(ctu, lx, refidx, npred):
    """mvp2nd (h265.cpp:3755-3768)."""
    lx_i = lx
    for _ in range(2):
        nri = npred.ref_idx[lx_i]
        if nri >= 0:
            sc = ctu.colpics.tmv_scale(lx, refidx, lx_i, nri)
            return [scale_mv(npred.mv[lx_i][0], sc),
                    scale_mv(npred.mv[lx_i][1], sc)]
        lx_i ^= 1
    return [0, 0]  # unreachable for non-intra neighbours


def _find_spatial_mvp(ctu, nb, lx, refpoc, ref_idx, state):
    """find_spatial_mvp (h265.cpp:3770-3792). state = [skip2nd,
    match2nd, mvp2]; returns the first-class mv or None."""
    if nb.pu_intra:
        return None
    lx_i = lx
    for _ in range(2):
        nri = nb.pred.ref_idx[lx_i]
        if nri >= 0:
            npoc = ctu.hdr.ref_list[lx_i][nri][0]
            if npoc == refpoc:
                state[0] = True
                return nb.pred.mv[lx_i]
            if not state[0] and not state[1]:
                state[2] = _mvp2nd(ctu, lx, ref_idx, nb.pred)
                state[1] = True
        lx_i ^= 1
    state[0] = True
    return None


def _mvp_one_dir(ctu, unavail, arr, i0, lefttop, span, lx, ref_idx,
                 state):
    """mvp_one_dir (h265.cpp:3794-3820)."""
    dir_flag = (unavail >> 1) if lefttop is not None else unavail
    refpoc = ctu.hdr.ref_list[lx][ref_idx][0]
    state[1] = False  # match2nd reset per direction
    span >>= 2
    if not (dir_flag & 4):
        mv = _find_spatial_mvp(ctu, arr[i0 + span], lx, refpoc, ref_idx,
                               state)
        if mv is not None:
            return mv
    if not (dir_flag & 1):
        mv = _find_spatial_mvp(ctu, arr[i0 + span - 1], lx, refpoc,
                               ref_idx, state)
        if mv is not None:
            return mv
    if lefttop is not None and not (unavail & 3):
        mv = _find_spatial_mvp(ctu, lefttop, lx, refpoc, ref_idx, state)
        if mv is not None:
            return mv
    if state[1]:
        return state[2]
    return None


def _add_mvp(mv, mvplist, mvp_idx):
    """add_mvp (h265.cpp:3742-3753): dedup + enough-candidates test."""
    for e in mvplist:
        if e[0] == mv[0] and e[1] == mv[1]:
            return False
    mvplist.append([mv[0], mv[1]])
    return mvp_idx < len(mvplist)


def calc_mv(ctu, unavail, width, height, left_arr, left_i, top_arr,
            top_i, lefttop, lx, ref_idx, mvp_idx, mvd, col):
    """calc_mv (h265.cpp:3822-3846)."""
    mvplist = []
    state = [False, False, None]  # skip2nd, match2nd, mvp2
    mvp = _mvp_one_dir(ctu, unavail, left_arr, left_i, None, height, lx,
                       ref_idx, state)
    if mvp is None or not _add_mvp(mvp, mvplist, mvp_idx):
        mvp = _mvp_one_dir(ctu, unavail, top_arr, top_i, lefttop, width,
                           lx, ref_idx, state)
        if mvp is None or not _add_mvp(mvp, mvplist, mvp_idx):
            got = False
            if col is not None:
                p = PredInfo()
                _add_colpic_candidate(ctu, p, col, lx, ref_idx)
                side = lx if p.ref_idx[lx] >= 0 else lx ^ 1
                got = _add_mvp(p.mv[side], mvplist, mvp_idx)
            if not got:
                while len(mvplist) < 2:
                    mvplist.append([0, 0])
    return [_i16(mvd[0] + mvplist[mvp_idx][0]),
            _i16(mvd[1] + mvplist[mvp_idx][1])]


def _pred_onedir(ctu, lx, ref_idx, mv, offset_x, offset_y, width,
                 height):
    """inter_pred_onedir math: returns (luma_vals, lshift, cb, cr)."""
    sps = ctu.sps
    frame = ctu.ref_frames[ctu.hdr.ref_list[lx][ref_idx][1]]
    xpos = (ctu.pos_x << ctu.size_log2) + offset_x
    ypos = (ctu.pos_y << ctu.size_log2) + offset_y
    lv, ls = IP.interp_luma(frame["y"], xpos, ypos, width, height,
                            mv[0], mv[1], sps.pic_width, sps.pic_height)
    cbv, crv = IP.interp_chroma(frame["cb"], frame["cr"], xpos, ypos,
                                width, height, mv[0], mv[1],
                                sps.pic_width, sps.pic_height)
    return lv, ls, cbv, crv


def motion_compensate(ctu, pred, offset_x, offset_y, width, height,
                      no_bidir=False):
    """merge_pred's MC half (h265.cpp:3572-3596)."""
    y0 = (ctu.pos_y << ctu.size_log2) + offset_y
    x0 = (ctu.pos_x << ctu.size_log2) + offset_x
    ref0, ref1 = pred.ref_idx
    if ctu.rec is not None:
        bidir = ref0 >= 0 and ref1 >= 0 and not no_bidir
        s0 = ctu.hdr.ref_list[0][ref0][1] if ref0 >= 0 else -1
        s1 = ctu.hdr.ref_list[1][ref1][1] if (ref1 >= 0 and bidir) else -1
        if s0 < 0 and not bidir and ref1 >= 0:
            # uni-L1 routes through slot1 (Phase B mirrors the lx pick)
            s1 = ctu.hdr.ref_list[1][ref1][1]
        ctu.rec.inter(x0, y0, width, height, s0, s1,
                      pred.mv[0], pred.mv[1])
    if ref0 >= 0 and ref1 >= 0 and not no_bidir:
        lv0, ls0, cb0, cr0 = _pred_onedir(ctu, 0, ref0, pred.mv[0],
                                          offset_x, offset_y, width,
                                          height)
        lv1, ls1, cb1, cr1 = _pred_onedir(ctu, 1, ref1, pred.mv[1],
                                          offset_x, offset_y, width,
                                          height)
        IP.writeback_bidir(ctu.frame["y"], y0, x0,
                           IP.to_bidir(lv0, ls0), lv1, ls1)
        IP.writeback_bidir(ctu.frame["cb"], y0 >> 1, x0 >> 1,
                           IP.to_bidir(cb0, 12), cb1, 12)
        IP.writeback_bidir(ctu.frame["cr"], y0 >> 1, x0 >> 1,
                           IP.to_bidir(cr0, 12), cr1, 12)
    else:
        lx = 0 if ref0 >= 0 else 1
        ref = ref0 if ref0 >= 0 else ref1
        lv, ls, cbv, crv = _pred_onedir(ctu, lx, ref, pred.mv[lx],
                                        offset_x, offset_y, width,
                                        height)
        IP.store_onedir(ctu.frame["y"], y0, x0, lv, ls)
        IP.store_onedir(ctu.frame["cb"], y0 >> 1, x0 >> 1, cbv, 12)
        IP.store_onedir(ctu.frame["cr"], y0 >> 1, x0 >> 1, crv, 12)


def _copy_predinfo(arr, i0, length, pred, no_bidir, skip):
    for k in range(length >> 2):
        nb = arr[i0 + k]
        nb.pu_nonzero_coef = 0
        nb.pu_intra = 0
        nb.skip = skip
        nb.pred = pred.copy()
        if no_bidir:
            nb.pred.ref_idx[1] = -1


def prediction_unit_merge(ctu, r, unavail, offset_x, offset_y, width,
                          height, left_arr, left_i, top_arr, top_i,
                          lefttop, skip_unused):
    idx = C.merge_idx(ctu.cb, r, ctu.hdr.max_num_merge_cand)
    pred = merge_list(ctu, idx, unavail, offset_x, offset_y, width,
                      height, left_arr, left_i, top_arr, top_i, lefttop)
    no_bidir = (pred.ref_idx[0] >= 0 and pred.ref_idx[1] >= 0
                and width + height == 12)
    motion_compensate(ctu, pred, offset_x, offset_y, width, height,
                      no_bidir)
    ctu.deblocking.record_pu(ctu.qpy, width, height, offset_x, offset_y,
                             unavail, left_arr, left_i, top_arr, top_i,
                             pred.ref_idx[0],
                             -1 if no_bidir else pred.ref_idx[1],
                             pred.mv)
    # copy_predinfo always marks skip=1; the caller's mode fill then
    # sets the final skip value (h265.cpp:3119-3131, 4049-4060)
    _copy_predinfo(left_arr, left_i, height, pred, no_bidir, 1)
    _copy_predinfo(top_arr, top_i, width, pred, no_bidir, 1)
    ctu.colpics.fill(offset_x, offset_y, width, height, pred=pred,
                     ref0=pred.ref_idx[0],
                     ref1=-1 if no_bidir else pred.ref_idx[1])


_AVAIL2X1IDX0 = (0, 1, 2, 3, 0, 5, 2, 7, 8, 9, 10, 11, 8, 13, 10, 15)
_AVAIL2X1IDX1 = (8, 9, 8, 9, 12, 13, 12, 13, 8, 9, 8, 9, 12, 13, 12, 13)
_AVAIL1X2IDX0 = (0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 10, 11, 4, 5, 14, 15)
_AVAIL1X2IDX1 = (4, 4, 6, 6, 4, 4, 6, 6, 12, 12, 14, 14, 12, 12, 14, 14)


def prediction_unit(ctu, r, size_log2, unavail, offset_x, offset_y,
                    width, height, left_arr, left_i, top_arr, top_i,
                    lefttop, pred_unavail=0):
    """prediction_unit (h265.cpp:3903-3948): merge or AMVP for one PU.
    Returns True when the PU was merged (rqt_root_cbf inference)."""
    cb = ctu.cb
    if C.merge_flag(cb, r):
        prediction_unit_merge(ctu, r, unavail | pred_unavail, offset_x,
                              offset_y, width, height, left_arr, left_i,
                              top_arr, top_i, lefttop, 0)
        return True
    if ctu.hdr.slice_type == 0:
        depth = ctu.size_log2 - size_log2
        pred_idc = C.inter_pred_idc(cb, r, width, height, depth)
    else:
        pred_idc = 0
    col = ctu.colpics.get_ref(offset_x, offset_y, width, height) \
        if ctu.hdr.temporal_mvp else None
    if col is not None and col.pu_intra:
        col = None
    pred = PredInfo()
    if pred_idc != 1:
        ref0 = C.ref_idx_lx(cb, r, 0, ctu.hdr.num_ref_idx_minus1)
        mvd = C.mvd_coding(cb, r)
        mvp_idx = C.mvp_lx_flag(cb, r)
        pred.ref_idx[0] = ref0
        pred.mv[0] = calc_mv(ctu, unavail, width, height, left_arr,
                             left_i, top_arr, top_i, lefttop, 0, ref0,
                             mvp_idx, mvd, col)
    if pred_idc != 0:
        ref1 = C.ref_idx_lx(cb, r, 1, ctu.hdr.num_ref_idx_minus1)
        if pred_idc == 1 or not ctu.hdr.mvd_l1_zero:
            mvd = C.mvd_coding(cb, r)
        else:
            mvd = (0, 0)
        mvp_idx = C.mvp_lx_flag(cb, r)
        pred.ref_idx[1] = ref1
        pred.mv[1] = calc_mv(ctu, unavail, width, height, left_arr,
                             left_i, top_arr, top_i, lefttop, 1, ref1,
                             mvp_idx, mvd, col)
    motion_compensate(ctu, pred, offset_x, offset_y, width, height)
    ctu.deblocking.record_pu(ctu.qpy, width, height, offset_x, offset_y,
                             unavail, left_arr, left_i, top_arr, top_i,
                             pred.ref_idx[0], pred.ref_idx[1], pred.mv)
    for arr, i0, length in ((left_arr, left_i, height),
                            (top_arr, top_i, width)):
        for k in range(length >> 2):
            nb = arr[i0 + k]
            nb.pu_intra = 0
            nb.pu_nonzero_coef = 0
            nb.skip = 0
            nb.pred = pred.copy()
    ctu.colpics.fill(offset_x, offset_y, width, height, pred=pred,
                     ref0=pred.ref_idx[0], ref1=pred.ref_idx[1])
    return False


def prediction_unit_cases(ctu, r, size_log2, unavail, offset_x,
                          offset_y, left_arr, left_i, top_arr, top_i,
                          lefttop):
    """prediction_unit_cases (h265.cpp:3949-4009). Returns
    (mode, rqt_root_cbf_inferred)."""
    cb = ctu.cb
    mode = C.part_mode_inter(cb, r, size_log2, ctu.size_log2_min,
                             ctu.sps.amp_enabled)
    length = 1 << size_log2
    inferred = False
    if mode == 0:  # 2Nx2N
        inferred = prediction_unit(ctu, r, size_log2, unavail, offset_x,
                                   offset_y, length, length, left_arr,
                                   left_i, top_arr, top_i, lefttop)
    elif mode == 1:  # 2NxN
        ls = length >> 1
        lt0 = left_arr[left_i + (length >> 3) - 1].copy()
        prediction_unit(ctu, r, size_log2, _AVAIL2X1IDX0[unavail],
                        offset_x, offset_y, length, ls, left_arr,
                        left_i, top_arr, top_i, lefttop)
        prediction_unit(ctu, r, size_log2, _AVAIL2X1IDX1[unavail],
                        offset_x, offset_y + ls, length, ls, left_arr,
                        left_i + (length >> 3), top_arr, top_i, lt0, 2)
    elif mode == 2:  # Nx2N
        ls = length >> 1
        lt0 = top_arr[top_i + (length >> 3) - 1].copy()
        prediction_unit(ctu, r, size_log2, _AVAIL1X2IDX0[unavail],
                        offset_x, offset_y, ls, length, left_arr,
                        left_i, top_arr, top_i, lefttop)
        prediction_unit(ctu, r, size_log2, _AVAIL1X2IDX1[unavail],
                        offset_x + ls, offset_y, ls, length, left_arr,
                        left_i, top_arr, top_i + (length >> 3), lt0, 1)
    elif mode == 3:
        # NxN: the reference passes an uninitialized lefttops[2] to the
        # fourth PU (h265.cpp:3977-3985) — indeterminate domain
        raise NotImplementedError(
            "reference-indeterminate: NxN inter (uninitialized lefttop)")
    elif mode == 4:  # 2NxnU
        ls = length >> 2
        lt0 = left_arr[left_i + (length >> 4) - 1].copy()
        prediction_unit(ctu, r, size_log2, _AVAIL2X1IDX0[unavail],
                        offset_x, offset_y, length, ls, left_arr,
                        left_i, top_arr, top_i, lefttop)
        prediction_unit(ctu, r, size_log2, _AVAIL2X1IDX1[unavail],
                        offset_x, offset_y + ls, length, length - ls,
                        left_arr, left_i + (length >> 4), top_arr,
                        top_i, lt0, 2)
    elif mode == 5:  # 2NxnD
        ls = length >> 2
        lt0 = left_arr[left_i + ((length - ls) >> 2) - 1].copy()
        prediction_unit(ctu, r, size_log2, _AVAIL2X1IDX0[unavail],
                        offset_x, offset_y, length, length - ls,
                        left_arr, left_i, top_arr, top_i, lefttop)
        prediction_unit(ctu, r, size_log2, _AVAIL2X1IDX1[unavail],
                        offset_x, offset_y + length - ls, length, ls,
                        left_arr, left_i + ((length - ls) >> 2),
                        top_arr, top_i, lt0, 2)
    elif mode == 6:  # nLx2N
        ls = length >> 2
        lt0 = top_arr[top_i + (length >> 4) - 1].copy()
        prediction_unit(ctu, r, size_log2, _AVAIL1X2IDX0[unavail],
                        offset_x, offset_y, ls, length, left_arr,
                        left_i, top_arr, top_i, lefttop)
        prediction_unit(ctu, r, size_log2, _AVAIL1X2IDX1[unavail],
                        offset_x + ls, offset_y, length - ls, length,
                        left_arr, left_i, top_arr,
                        top_i + (length >> 4), lt0, 1)
    elif mode == 7:  # nRx2N
        ls = length >> 2
        lt0 = top_arr[top_i + ((length - ls) >> 2) - 1].copy()
        prediction_unit(ctu, r, size_log2, _AVAIL1X2IDX0[unavail],
                        offset_x, offset_y, length - ls, length,
                        left_arr, left_i, top_arr, top_i, lefttop)
        prediction_unit(ctu, r, size_log2, _AVAIL1X2IDX1[unavail],
                        offset_x + length - ls, offset_y, ls, length,
                        left_arr, left_i, top_arr,
                        top_i + ((length - ls) >> 2), lt0, 1)
    return mode, inferred


def pred_inter(ctu, r, size_log2, unavail, offset_x, offset_y, valid_x,
               valid_y, left_arr, left_i, top_arr, top_i, lefttop):
    """pred_inter (h265.cpp:4044-4073): skip / merge / intra switch."""
    cb = ctu.cb
    num = 1 << (size_log2 - 2)
    skip = C.cu_skip_flag(cb, r, unavail,
                          left_arr[left_i].skip, top_arr[top_i].skip)
    size = 1 << size_log2
    if skip:
        prediction_unit_merge(ctu, r, unavail, offset_x, offset_y, size,
                              size, left_arr, left_i, top_arr, top_i,
                              lefttop, 1)
        for k in range(num):
            for arr, i0 in ((left_arr, left_i), (top_arr, top_i)):
                nb = arr[i0 + k]
                nb.tu_intra = 0
                nb.skip = 1
                nb.pred_mode = 1  # INTRA_DC
                nb.pu_nonzero_coef = 0
                nb.tu_nonzero_coef = 0
        return
    if C.pred_mode_flag(cb, r):
        ctu.pred_intra(r, size_log2, unavail, offset_x, offset_y,
                       valid_x, valid_y, left_arr, left_i, top_arr,
                       top_i)
        return
    mode, inferred = prediction_unit_cases(ctu, r, size_log2, unavail,
                                           offset_x, offset_y, left_arr,
                                           left_i, top_arr, top_i,
                                           lefttop)
    if inferred or C.rqt_root_cbf(cb, r):
        ctu.order_luma = [0, 0, 0, 0]
        ctu.order_chroma = 0
        ctu.intra_split = int(
            mode != 0
            and ctu.sps.max_transform_hierarchy_depth_inter == 0)
        ctu.transform_tree(r, size_log2, unavail, 0, 3, offset_x,
                           valid_x, offset_y, valid_y, 0, 0, False,
                           left_arr, left_i, top_arr, top_i)
    else:
        for k in range(num):
            for arr, i0 in ((left_arr, left_i), (top_arr, top_i)):
                nb = arr[i0 + k]
                nb.pu_nonzero_coef = 0
                nb.tu_nonzero_coef = 0
    for k in range(num):
        for arr, i0 in ((left_arr, left_i), (top_arr, top_i)):
            nb = arr[i0 + k]
            nb.tu_intra = 0
            nb.skip = 0
            nb.pred_mode = 1
