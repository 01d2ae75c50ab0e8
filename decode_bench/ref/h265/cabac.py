"""H.265 CABAC: shared arithmetic engine + HEVC syntax-element readers.

The arithmetic engine is the same spec 9.3 engine as H.264 (reference
shares it in m2d.h:130-279); only the context bank differs: 157 contexts
initialized from cabac_initial_value (h265.cpp:941) with the init type
idc = 0 for I slices, else 2 - (slice_type ^ cabac_init_flag)
(ctu_init, h265.cpp:4755).

Syntax readers mirror h265.cpp:1134-1360 with the same context-increment
derivations; offsets into the context bank follow the reference's
h265d_cabac_context_t layout (cabac_tables.py).
"""

from __future__ import annotations

from decode_bench.ref.h264.cabac import CabacEngine
from decode_bench.ref.h265 import cabac_tables as CT


class H265Cabac(CabacEngine):
    """CabacEngine with the HEVC context bank."""

    def __init__(self):
        super().__init__()
        self.ctx = [0] * CT.NUM_CTX

    def init_context(self, slice_qp, idc):
        ctx = self.ctx
        for i, (m, n) in enumerate(CT.INIT_MN[idc]):
            pre = ((m * slice_qp) >> 4) + n
            if pre < 64:
                pre = 1 if pre <= 0 else pre
                ctx[i] = (63 - pre) * 2
            else:
                pre = 126 if pre > 126 else pre
                ctx[i] = (pre - 64) * 2 + 1


# ---------------------------------------------------------------------
# syntax readers (cb = H265Cabac, r = BitReader)
# ---------------------------------------------------------------------

def split_cu_flag(cb, r, size_log2, left_depth, top_depth):
    """h265.cpp:1134."""
    inc = (6 < size_log2 + left_depth) + (6 < size_log2 + top_depth)
    return cb.decision(r, CT.SPLIT_CU_FLAG + inc)


def cu_skip_flag(cb, r, unavail, left_skip, top_skip):
    idx = ((not (unavail & 1)) and left_skip) + \
          ((not (unavail & 2)) and top_skip)
    return cb.decision(r, CT.CU_SKIP_FLAG + int(idx))


def merge_flag(cb, r):
    return cb.decision(r, CT.MERGE_FLAG)


def merge_idx(cb, r, maxidx):
    """h265.cpp:1144-1155 (TU-coded with one context bin)."""
    if maxidx <= 1 or not cb.decision(r, CT.MERGE_IDX):
        return 0
    idx = 1
    while idx < maxidx - 1 and cb.bypass(r):
        idx += 1
    return idx


def pred_mode_flag(cb, r):
    return cb.decision(r, CT.PRED_MODE_FLAG)


def part_mode_intra(cb, r):
    return cb.decision(r, CT.PART_MODE)


def prev_intra_luma_pred_flag(cb, r):
    return cb.decision(r, CT.PREV_INTRA_LUMA_PRED_FLAG)


def mpm_idx(cb, r):
    return 1 + cb.bypass(r) if cb.bypass(r) else 0


def rem_intra_luma_pred_mode(cb, r, cand):
    """h265.cpp:1273-1280: 5 bypass bins + sorted-candidate skip."""
    mode = cb.multibypass(r, 5)
    for c in sorted(cand):
        mode += c <= mode
    return mode


def intra_chroma_pred_mode(cb, r):
    if cb.decision(r, CT.INTRA_CHROMA_PRED_MODE):
        return cb.multibypass(r, 2)
    return 4


def rqt_root_cbf(cb, r):
    return cb.decision(r, CT.RQT_ROOT_CBF)


def split_transform_flag(cb, r, size_log2):
    return cb.decision(r, CT.SPLIT_TRANSFORM_FLAG + 5 - size_log2)


def cbf_chroma(cb, r, depth):
    return cb.decision(r, CT.CBF_CHROMA + depth)


def cbf_luma(cb, r, depth):
    return cb.decision(r, CT.CBF_LUMA + (depth == 0))


def transform_skip_flag(cb, r, colour):
    return cb.decision(r, CT.TRANSFORM_SKIP_FLAG + ((colour + 1) >> 1))


def last_sig_coeff_prefix(cb, r, ctx_base, shift, maxval):
    """h265.cpp:1291-1299."""
    idx = 0
    while idx < maxval:
        if not cb.decision(r, ctx_base + (idx >> shift)):
            break
        idx += 1
    return idx


_PREFIX_ADJ = (0x04, 0x06, 0x08, 0x0C, 0x10, 0x18)


def last_sig_coeff_suffix_add(cb, r, prefix):
    if prefix < 4:
        return prefix
    return _PREFIX_ADJ[prefix - 4] + cb.multibypass(r, (prefix >> 1) - 1)


def coded_sub_block_flag(cb, r, prev_sbf, colour):
    inc = ((prev_sbf & 1) | (prev_sbf >> 1)) + ((colour + 1) & 2)
    return cb.decision(r, CT.CODED_SUB_BLOCK_FLAG + inc)


def sig_coeff_flag(cb, r, inc):
    return cb.decision(r, CT.SIG_COEFF_FLAG + inc)


def coeff_abs_level_greater1_flag(cb, r, inc):
    return cb.decision(r, CT.COEFF_ABS_LEVEL_GREATER1_FLAG + inc)


def coeff_abs_level_greater2_flag(cb, r, inc):
    return cb.decision(r, CT.COEFF_ABS_LEVEL_GREATER2_FLAG + inc)


def coeff_sign_flags(cb, r, num):
    return cb.multibypass(r, num)


def coeff_abs_level_remaining(cb, r, rice):
    """h265.cpp:1335-1349: truncated-rice + exp-golomb escape."""
    i = 0
    while i < 20 and cb.bypass(r):
        i += 1
    if i < 4:
        return ((i << rice) + cb.multibypass(r, rice)) if rice else i
    i -= 4
    return (1 << (i + rice + 1)) + (2 << rice) \
        + cb.multibypass(r, i + rice + 1)


def end_of_slice_segment_flag(cb, r):
    """Same arithmetic as the shared terminate (h265.cpp:1350-1365)."""
    return cb.terminate(r)


# -- inter syntax (h265.cpp:1165-1260) --------------------------------

def part_mode_inter(cb, r, size_log2, min_size_log2, amp_enabled):
    def inter0():
        if cb.decision(r, CT.PART_MODE):
            return 0
        return 2 - cb.decision(r, CT.PART_MODE + 1)

    if min_size_log2 < size_log2:
        if not amp_enabled:
            return inter0()
        base = inter0()
        if base == 0 or cb.decision(r, CT.PART_MODE + 3):
            return base
        return (base + 1) * 2 + cb.bypass(r)
    if size_log2 == 3:
        return inter0()
    base = inter0()
    if base < 2:
        return base
    return base + (cb.decision(r, CT.PART_MODE + 2) ^ 1)


def inter_pred_idc(cb, r, width, height, depth):
    if width + height != 12 and cb.decision(r, CT.INTER_PRED_IDC + depth):
        return 2
    return cb.decision(r, CT.INTER_PRED_IDC + 4)


def ref_idx_lx(cb, r, lx, num_ref_idx_minus1):
    num = num_ref_idx_minus1[lx]
    if num <= 0:
        return 0
    idx = 0
    while idx < min(num, 2):
        if not cb.decision(r, CT.REF_IDX_LX + idx):
            return idx
        idx += 1
    while idx < num:
        if not cb.bypass(r):
            break
        idx += 1
    return idx


def abs_mvd_greater_flag(cb, r, idx):
    return cb.decision(r, CT.ABS_MVD_GREATER_FLAG + idx)


def abs_mvd_minus2(cb, r):
    bits = 0
    while cb.bypass(r):
        bits += 1
    return (2 << bits) - 2 + cb.multibypass(r, bits + 1)


def mvd_sign_flag(cb, r):
    return cb.bypass(r)


def mvp_lx_flag(cb, r):
    return cb.decision(r, CT.MVP_FLAG)


def mvd_coding(cb, r):
    """mvd_coding (h265.cpp:3723-3740)."""
    mvd0 = abs_mvd_greater_flag(cb, r, 0)
    mvd1 = abs_mvd_greater_flag(cb, r, 0)
    if mvd0:
        mvd0 += abs_mvd_greater_flag(cb, r, 1)
    if mvd1:
        mvd1 += abs_mvd_greater_flag(cb, r, 1)

    def suffix(v):
        if v:
            if 1 < v:
                v += abs_mvd_minus2(cb, r)
            v = -v if mvd_sign_flag(cb, r) else v
        return v

    return suffix(mvd0), suffix(mvd1)
