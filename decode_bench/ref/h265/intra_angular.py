"""H.265 angular intra prediction modes 2..34 (excl. 10/26).

Transliteration of the reference's table-driven angular machinery
(h265.cpp:2663-2812 + intrapos.h, tables behaviorally dumped to
intrapos_tables.py): a reference-sample array is assembled from
`intra_pred_pos` (projected "extra" samples from the opposite edge plus
a clamped run along the main edge), then the prediction walks
`intra_pred_coef` fraction/increment rows; pure-integer-angle modes
(mode-2 divisible by 8) copy shifted rows.  Raw mode index m = mode - 2;
m < 16 is the horizontal family (output transposed).
"""

from __future__ import annotations

from decode_bench.ref.h265.intra import (
    _Vec, _clip255, detect_strong_filter, multipix_filtered, multipix_raw,
    multipix_strong,
)
from decode_bench.ref.h265.intrapos_tables import COEF, POS

_FILTER_THR = (56, 48, 48, 48, 48, 48, 48, 32, 0, 32, 48, 48, 48, 48, 48,
               48)


def _get_pix_raw(src, offset, offset_min, offset_max):
    ofs = offset if offset_min <= offset else offset_min
    if ofs >= offset_max:
        ofs = offset_max - 1
    return src[ofs]


def _get_pix_filtered(src, offset, offset_min, offset_max):
    c1 = src[offset]
    if offset_min < offset:
        c0 = src[offset - 1]
        if offset < offset_max - 1:
            return (c0 + c1 * 2 + src[offset + 1] + 2) >> 2
        return (c0 + c1 * 3 + 2) >> 2
    return (c1 * 3 + src[offset + 1] + 2) >> 2


def _get_pix_strong(src, offset, offset_min, offset_max):
    c0 = src[-1 if offset_min < 0 else 0]
    c1 = src[min(63, offset_max - 1)]
    return ((63 - offset) * c0 + (offset + 1) * c1 + 32) >> 6


def _get_ref(plane, y0, x0, size_log2, horiz, valid_main, valid_sub,
             pos_tbl, kind):
    """intra_pred_get_ref (h265.cpp:2695-2713) on a planar plane.

    horiz (m<16): main edge = left column, sub/extras = top row.
    """
    extra_len = pos_tbl[0]
    base_pos = pos_tbl[1 + extra_len]
    base_len = pos_tbl[2 + extra_len]
    out = []
    if horiz:
        sub_vec = _Vec(plane, y0 - 1, x0, 0, 1)      # top row
        main_vec = _Vec(plane, y0, x0 - 1, 1, 0)     # left column
        sub_single = _Vec(plane, y0, x0 - 1, 0, 0)   # left pixel
        # filtered-base corner: src[sub_stride - stride] (h265.cpp:2590)
        corner = int(plane[y0 - 1, x0])
    else:
        sub_vec = _Vec(plane, y0, x0 - 1, 1, 0)
        main_vec = _Vec(plane, y0 - 1, x0, 0, 1)
        sub_single = _Vec(plane, y0 - 1, x0, 0, 0)
        corner = int(plane[y0, x0 - 1])
    getpix = {"raw": _get_pix_raw, "filtered": _get_pix_filtered,
              "strong": _get_pix_strong}[kind]
    if extra_len:
        if 0 < valid_sub:
            ofs_min = -1 if 0 < valid_main else 0
            for i in range(extra_len):
                out.append(getpix(sub_vec, pos_tbl[1 + i], ofs_min,
                                  valid_sub))
        elif 0 < valid_main:
            out.extend([sub_single[0]] * extra_len)
        else:
            out.extend([128] * extra_len)
    if 0 < valid_main:
        ofs_min = -1 if 0 < valid_sub else 0
        ofs_max = min(2 << size_log2, valid_main)
        if kind == "strong":
            out.extend(multipix_strong(main_vec, base_pos, ofs_min,
                                       ofs_max, size_log2, base_len))
        elif kind == "filtered":
            out.extend(multipix_filtered(main_vec, base_pos, ofs_min,
                                         ofs_max, size_log2, base_len,
                                         corner))
        else:
            out.extend(multipix_raw(main_vec, base_pos, ofs_min, ofs_max,
                                    size_log2, base_len))
    elif 0 < valid_sub:
        out.extend([_get_pix_raw(sub_vec, 0, 0, 4)] * base_len)
    else:
        out.extend([128] * base_len)
    return out


def pred_angular(plane, y0, x0, size_log2, valid_x, valid_y, mode,
                 is_luma, strong_enabled):
    """intra_pred_angular (h265.cpp:2780-2802)."""
    m = mode - 2
    horiz = m < 16
    if is_luma and (_FILTER_THR[m & 15] & (1 << size_log2)):
        if detect_strong_filter(strong_enabled, plane, y0, x0, size_log2,
                                valid_x, valid_y):
            kind = "strong"
        else:
            kind = "filtered"
    else:
        kind = "raw"
    pos_tbl = POS[m][size_log2 - 2]
    if horiz:
        ref = _get_ref(plane, y0, x0, size_log2, True, valid_y, valid_x,
                       pos_tbl, kind)
    else:
        ref = _get_ref(plane, y0, x0, size_log2, False, valid_x, valid_y,
                       pos_tbl, kind)
    size = 1 << size_log2
    # the reference's neighbour[] is a 64-byte stack buffer; some modes
    # read one slot past the written length with a zero filter weight
    # (benign garbage read) — pad so the weighted-zero read is defined
    ref = ref + [0] * (2 * size + 2 - len(ref)) if len(ref) < 2 * size + 2 \
        else ref
    coef = COEF[m][0]
    inc = COEF[m][1]
    if m & 7:
        # intra_pred_angular_filter (h265.cpp:2744-2762)
        src = inc[0] >> (5 - size_log2)
        for yy in range(size):
            c1 = coef[yy]
            c0 = 32 - c1
            d0 = ref[src]
            for xx in range(size):
                d1 = ref[src + 1 + xx]
                v = (d0 * c0 + d1 * c1 + 16) >> 5
                if horiz:
                    plane[y0 + xx, x0 + yy] = v
                else:
                    plane[y0 + yy, x0 + xx] = v
                d0 = d1
            if 1 + yy < len(inc):  # ref overreads inc[32] on the last
                src += inc[1 + yy]  # row; the value is never used
    else:
        # intra_pred_diagonal (h265.cpp:2774-2786): plain row copies for
        # BOTH families (the m=0 pattern is x/y-symmetric, the reference
        # never transposes here)
        src = inc[0] >> (5 - size_log2)
        step = inc[1]
        for yy in range(size):
            row = ref[src : src + size]
            for xx in range(size):
                plane[y0 + yy, x0 + xx] = row[xx]
            src += step
