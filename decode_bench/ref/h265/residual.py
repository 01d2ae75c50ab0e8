"""H.265 residual decode: CABAC coefficient parse + inverse transforms.

Mirrors the reference exactly (h265.cpp:1575-2234):
* scan orders / sig-coeff context tables behaviorally dumped
  (residual_tables.py);
* dequant `scaling_default_base`: sat16((val*scale + (1<<(L-2))) >> (L-1))
  with the qp_scale table and chroma qp mapping (h265.cpp:2967-2994);
* coefficient buffer is persistent and cleared ONLY when the last
  position is nonzero — the DC-only path deliberately reads a possibly
  stale buffer at positions it never touches (h265.cpp:2194-2196);
* partial butterflies with sat16<7> column and sat16<12> row saturation,
  DST 4x4 for intra luma, horizontal/vertical-only fast paths chosen by
  the OR of written positions, DC-only path with byte-lane wraparound of
  the adjusted DC (acNxNtransform_dconly_base, m2d.h:307-326);
* CLIP255C add with the LUT-domain caveat (generators keep residuals
  small enough for pred+res to stay in [-256, 767]).
"""

from __future__ import annotations

from decode_bench.ref.h265 import cabac as C
from decode_bench.ref.h265 import cabac_tables as CT
from decode_bench.ref.h265 import residual_tables as RT

QP_SCALE = (
    40, 45, 51, 57, 64, 72, 80, 90, 102, 114, 128, 144,
    160, 180, 204, 228, 256, 288, 320, 360, 408, 456, 512, 576,
    640, 720, 816, 912, 1024, 1152, 1280, 1440, 1632, 1824, 2048, 2304,
    2560, 2880, 3264, 3648, 4096, 4608, 5120, 5760, 6528, 7296, 8192,
    9216, 10240, 11520, 13056, 14592,
)

QPC_ADJ = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30,
    31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37, 38, 39, 40, 41,
    42, 43, 44, 45,
)


def qp_to_scale(qpy, qpc_delta):
    """qp_to_scale (h265.cpp:2967-2985): luma + two chroma scales."""
    return (QP_SCALE[qpy],
            QP_SCALE[QPC_ADJ[(qpy + qpc_delta[0]) % 52]],
            QP_SCALE[QPC_ADJ[(qpy + qpc_delta[1]) % 52]])


def _sat16(v):
    return -32768 if v < -32768 else (32767 if v > 32767 else v)


def _clip255(v):
    return 0 if v < 0 else (255 if v > 255 else v)


def _dequant(val, scale, size_log2):
    l = size_log2
    return _sat16((val * scale + (1 << (l - 2))) >> (l - 1))


def order_map(idx):
    """order_map (h265.cpp:2226-2244)."""
    idx = (idx - 6) & 31
    return ((idx & 15) <= 8) << (1 if idx <= 15 else 0)


# ---------------------------------------------------------------------
# coefficient parse (residual_coding, h265.cpp:2186-2224)
# ---------------------------------------------------------------------

def residual_coding(ctu, r, size_log2, colour, plane, y0, x0, order_idx,
                    is_intra):
    cb = ctu.cb
    if (size_log2 == 2 and ctu.pps.transform_skip_enabled
            and C.transform_skip_flag(cb, r, colour)):
        tskip = True
    else:
        tskip = False
    maxpre = size_log2 * 2 - 1
    raw = RT.LAST_SIG_COEF_PARAM[(colour + 1) >> 1][size_log2 - 2]
    ofs, shift = raw & 15, raw >> 4
    x = C.last_sig_coeff_prefix(cb, r, CT.LAST_SIG_COEFF_X_PREFIX + ofs,
                                shift, maxpre)
    y = C.last_sig_coeff_prefix(cb, r, CT.LAST_SIG_COEFF_Y_PREFIX + ofs,
                                shift, maxpre)
    last_x = C.last_sig_coeff_suffix_add(cb, r, x)
    last_y = C.last_sig_coeff_suffix_add(cb, r, y)
    coeff = ctu.coeff_buf
    if last_x or last_y:
        for k in range(1 << (size_log2 * 2)):
            coeff[k] = 0
    if order_idx == 2:
        last_x, last_y = last_y, last_x
    order = RT.SCAN_ORDER[order_idx][size_log2 - 2]
    inc_idx = RT.SIG_INC_TBLIDX[order_idx][(colour + 1) >> 1][size_log2 - 2]
    inc_ofs = RT.SIG_INC_OFSET[order_idx][(colour + 1) >> 1][size_log2 - 2]
    sub_log2 = size_log2 - 2
    pos_max = (1 << sub_log2) - 1
    last_subblock_pos = order["sub_block_num"][
        ((last_y >> 2) << sub_log2) + (last_x >> 2)]
    i = last_subblock_pos
    greater1ctx = 1
    num = RT.INNER_INV[order_idx][((last_y & 3) << 2) + (last_x & 3)]
    scale = ctu.qp_scale[colour]
    flags = [0] * 9  # sub_block_flags_t rows
    xy_pos_sum = 0
    sign_hiding = ctu.pps.sign_data_hiding
    while i >= 0:
        sxy = order["sub_block_pos"][i]
        sx = sxy & pos_max
        sy = sxy >> sub_log2
        prev_sbf = ((flags[sy] >> (sx + 1)) & 1) + \
            (((flags[sy + 1] >> sx) & 1) * 2)
        if ((last_subblock_pos - 1) & 0xFFFFFFFF) <= ((i - 1) & 0xFFFFFFFF) \
                or C.coded_sub_block_flag(cb, r, prev_sbf, colour):
            flags[sy] |= 1 << sx
            inc_tbl = RT.SIG_INC_TBL[inc_idx[sxy != 0][prev_sbf]]
            # sig_coeff_flags_read (h265.cpp:1575-1590)
            coeffs = []  # (pos, val)
            pos = num
            if i == last_subblock_pos:
                coeffs.append([pos, 1])
                pos -= 1
            while 0 < pos:
                if C.sig_coeff_flag(cb, r, inc_ofs + inc_tbl[pos]):
                    coeffs.append([pos, 1])
                pos -= 1
            if pos == 0 and ((not coeffs and sxy) or C.sig_coeff_flag(
                    cb, r, inc_ofs + inc_tbl[0])):
                coeffs.append([0, 1])
            num_coeff = len(coeffs)
            if num_coeff == 0:
                break
            # sig_coeff_greater (h265.cpp:1594-1624)
            ctxset = (2 if (colour == 0 and i != 0) else 0) + \
                (greater1ctx == 0)
            g1ofs = ctxset * 4 + (0 if colour == 0 else 16)
            greater1ctx = 1
            max_flags = 0
            last_g1 = -1
            for j in range(min(num_coeff, 8)):
                if C.coeff_abs_level_greater1_flag(cb, r,
                                                   g1ofs + greater1ctx):
                    greater1ctx = 0
                    coeffs[j][1] = 2
                    if last_g1 >= 0:
                        max_flags |= 1 << j
                    else:
                        last_g1 = j
                elif ((greater1ctx - 1) & 0xFFFFFFFF) < 2:
                    greater1ctx += 1
            if last_g1 >= 0:
                if C.coeff_abs_level_greater2_flag(
                        cb, r, ctxset if colour == 0 else ctxset + 4):
                    coeffs[last_g1][1] = 3
                    max_flags |= 1 << last_g1
            if num_coeff > 8:
                max_flags |= ((1 << num_coeff) - 1) & ~255
            hidden = int(sign_hiding
                         and 3 < coeffs[0][0] - coeffs[-1][0])
            sign_flags = C.coeff_sign_flags(cb, r, num_coeff - hidden)
            # sig_coeff_writeback (h265.cpp:1626-1652)
            rice = 0
            sign_mask = 1 << (num_coeff - 1 - hidden)
            level_sum = 0
            write_pos = ((sy << (sub_log2 + 2)) + sx) * 4
            mf = max_flags
            last_wp = 0
            for pos, val in coeffs:
                abs_level = val
                if mf & 1:
                    abs_level += C.coeff_abs_level_remaining(cb, r, rice)
                    rice = min(rice + ((3 << rice) < abs_level), 4)
                level_sum += abs_level
                last_wp = write_pos + order["macro_xy_pos"][pos]
                xy_pos_sum |= last_wp
                sign = 1 if sign_flags & sign_mask else 0
                coeff[last_wp] = _dequant(-abs_level if sign else abs_level,
                                          scale, size_log2)
                sign_mask >>= 1
                mf >>= 1
            if hidden and (level_sum & 1):
                coeff[last_wp] = -coeff[last_wp]
        num = 15
        i -= 1
    use_dst = is_intra and colour == 0 and size_log2 == 2
    if ctu.rec is not None:
        ctu.rec.residual(colour, y0, x0, size_log2, coeff, xy_pos_sum,
                         tskip, use_dst)
    if not tskip:
        transform(coeff, size_log2, plane, y0, x0, xy_pos_sum, use_dst)
    else:
        skip_transform(coeff, plane, y0, x0, xy_pos_sum)


# ---------------------------------------------------------------------
# inverse transforms (h265.cpp:1694-2146)
# ---------------------------------------------------------------------

_ODDC8 = (
    (90, 87, 80, 70, 57, 43, 25, 9),
    (87, 57, 9, -43, -80, -90, -70, -25),
    (80, 9, -70, -87, -25, 57, 90, 43),
    (70, -43, -87, 9, 90, 25, -80, -57),
    (57, -80, -25, 90, -9, -87, 43, 70),
    (43, -90, 57, 25, -87, 70, 9, -80),
    (25, -70, 90, -80, 43, 9, -57, 87),
    (9, -25, 43, -57, 70, -80, 87, -90),
)

_ODDC16 = (
    (90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4),
    (90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38,
     -13),
    (88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22),
    (85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78,
     -31),
    (82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38),
    (78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90,
     -46),
    (73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85,
     54),
    (67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73,
     -61),
    (61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54,
     67),
    (54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31,
     -73),
    (46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78),
    (38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22,
     -82),
    (31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46,
     85),
    (22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67,
     -88),
    (13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82,
     90),
    (4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90,
     -90),
)


def _sat7(v):
    return _sat16((v + 64) >> 7)


def _sat12(v):
    return _sat16((v + 2048) >> 12)


def _line4(coeff, step, sat):
    c0, c1, c2, c3 = coeff[0], coeff[step], coeff[2 * step], coeff[3 * step]
    odd0 = c1 * 83 + c3 * 36
    even0 = (c0 + c2) * 64
    odd1 = c1 * 36 - c3 * 83
    even1 = (c0 - c2) * 64
    return [sat(even0 + odd0), sat(even1 + odd1), sat(even1 - odd1),
            sat(even0 - odd0)]


def _line8(coeff, step, sat):
    even = _line4(coeff, step * 2, lambda v: v)
    c = [coeff[k * step] for k in (1, 3, 5, 7)]
    eo = (89 * c[0] + 75 * c[1] + 50 * c[2] + 18 * c[3],
          75 * c[0] - 18 * c[1] - 89 * c[2] - 50 * c[3],
          50 * c[0] - 89 * c[1] + 18 * c[2] + 75 * c[3],
          18 * c[0] - 50 * c[1] + 75 * c[2] - 89 * c[3])
    out = [0] * 8
    for i in range(4):
        out[i] = sat(even[i] + eo[i])
        out[7 - i] = sat(even[i] - eo[i])
    return out


def _line16(coeff, step, sat):
    even = _line8(coeff, step * 2, lambda v: v)
    c = [coeff[k * step] for k in (1, 3, 5, 7, 9, 11, 13, 15)]
    out = [0] * 16
    for i in range(8):
        s = sum(cj * w for cj, w in zip(c, _ODDC8[i]))
        out[i] = sat(even[i] + s)
        out[15 - i] = sat(even[i] - s)
    return out


def _line32(coeff, step, sat):
    even = _line16(coeff, step * 2, lambda v: v)
    c = [coeff[(2 * k + 1) * step] for k in range(16)]
    out = [0] * 32
    for i in range(16):
        s = sum(cj * w for cj, w in zip(c, _ODDC16[i]))
        out[i] = sat(even[i] + s)
        out[31 - i] = sat(even[i] - s)
    return out


_LINE = {2: _line4, 3: _line8, 4: _line16, 5: _line32}


def _dst_line(coeff, step, sat):
    c0, c1, c2, c3 = coeff[0], coeff[step], coeff[2 * step], coeff[3 * step]
    d0 = c0 + c2
    d1 = c2 + c3
    d2 = c0 - c3
    d3 = c1 * 74
    return [sat(d0 * 29 + d1 * 55 + d3), sat(d2 * 55 - d1 * 29 + d3),
            sat((c0 - c2 + c3) * 74), sat(d0 * 55 + d2 * 29 - d3)]


def _add_block(plane, y0, x0, rows):
    for dy, row in enumerate(rows):
        for dx, v in enumerate(row):
            plane[y0 + dy, x0 + dx] = _clip255(
                int(plane[y0 + dy, x0 + dx]) + v)


def transform(coeff, size_log2, plane, y0, x0, xy_pos_sum, use_dst):
    size = 1 << size_log2
    mode = (size <= xy_pos_sum) * 2 + ((xy_pos_sum & (size - 1)) != 0)
    if use_dst:
        if mode == 0:
            d = [_sat7(coeff[0] * m) for m in (29, 55, 74, 84)]
            rows = [[_sat12(dd * m) for m in (29, 55, 74, 84)] for dd in d]
            _add_block(plane, y0, x0, rows)
        else:
            tmp = []
            for xx in range(4):
                tmp.append(_dst_line(coeff[xx:], 4, _sat7))
            # tmp[x][k] = column-transformed, row-major walk mirrors ref
            rows = []
            for yy in range(4):
                col = [tmp[k][yy] for k in range(4)]
                rows.append(_dst_line(col, 1, _sat12))
            _add_block(plane, y0, x0, rows)
        return
    line = _LINE[size_log2]
    if mode == 0:
        adj = (coeff[0] + 64) >> 7
        lane = (-adj if adj < 0 else adj) & 0xFF  # byte-lane wrap quirk
        sgn = -1 if adj < 0 else 1
        for dy in range(size):
            for dx in range(size):
                p = int(plane[y0 + dy, x0 + dx]) + sgn * lane
                plane[y0 + dy, x0 + dx] = _clip255(p)
    elif mode == 1:
        row = [(coeff[i] + 1) >> 1 for i in range(size)]
        out = line(row, 1, _sat12)
        for dy in range(size):
            _add_block(plane, y0 + dy, x0, [out])
    elif mode == 2:
        # NOTE: no pretruncate on the vertical path (transform_vert,
        # h265.cpp:1948-1967 — only transform_horiz pretruncates)
        col = [coeff[i << size_log2] for i in range(size)]
        out = line(col, 1, _sat7)
        for dy in range(size):
            diff = (out[dy] + 32) >> 6
            for dx in range(size):
                plane[y0 + dy, x0 + dx] = _clip255(
                    int(plane[y0 + dy, x0 + dx]) + diff)
    else:
        tmp = []
        for xx in range(size):
            tmp.append(line(coeff[xx:], size, _sat7))
        rows = []
        for yy in range(size):
            col = [tmp[k][yy] for k in range(size)]
            rows.append(line(col, 1, _sat12))
        _add_block(plane, y0, x0, rows)


def skip_transform(coeff, plane, y0, x0, xy_pos_sum):
    """skip_transform (h265.cpp:2148-2167)."""
    if not xy_pos_sum:
        plane[y0, x0] = _clip255(int(plane[y0, x0]) + ((coeff[0] + 16) >> 5))
        return
    for yy in range(4):
        for xx in range(4):
            v = int(plane[y0 + yy, x0 + xx]) + ((coeff[yy * 4 + xx] + 16) >> 5)
            plane[y0 + yy, x0 + xx] = _clip255(v)
