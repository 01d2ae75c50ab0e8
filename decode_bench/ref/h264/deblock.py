"""H.264 in-loop deblocking: whole-frame post-pass.

Mirrors the reference's deblock_pb exactly (reference:
src/lib/h264.cpp:10253-10663): per-MB raster order, all vertical edges
(left MB edge + inner x=4,8,12) then all horizontal edges (top MB edge +
inner y=4,8,12), strengths from the per-MB 2-bit maps recorded during
decode, alpha/beta from the averaged QPs (the reference records qpy=0 and
qpc-qp *differences* for IPCM MBs — replicated as-is).

Strength map layout (str_vert/str_horiz, 32-bit): bits[2j:2j+2] of byte k:
edge group k (0=MB edge, 1..3=inner at 4/8/12), position j covering 4 luma
samples; chroma reuses byte 0 (MB edge) and byte 2 (middle edge).
"""

from __future__ import annotations

from . import tables as T


def _alpha_beta(qp, a_ofs, b_ofs):
    """AlphaBeta macro (h264.cpp:10253-10258): returns (indexA-16, indexB-16)
    i.e. negative => no filtering."""
    a = min(qp + a_ofs, 51) - 16
    b = min(qp + b_ofs, 51) - 16
    return a, b


def _clip3(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


def _filter_line(seg, str_val, alpha_idx, beta_idx, is_luma):
    """Filter one line across an edge: ``seg`` is the list of the 8
    samples normal to it, seg[k + 2] the sample k after q1 (q1 two
    samples before the edge), changed in place."""
    alpha = T.DEBLOCK_ALPHA[alpha_idx + 16]
    beta = T.DEBLOCK_BETA[beta_idx + 16]

    def get(k):
        return seg[k + 2]

    def put(k, v):
        seg[k + 2] = 0 if v < 0 else (255 if v > 255 else v)

    q1, q0, p0, p1 = get(0), get(1), get(2), get(3)
    if not abs(q1 - q0) < beta:
        return
    if not abs(q0 - p0) < alpha:
        return
    if not abs(p0 - p1) < beta:
        return
    if str_val == 4:
        if is_luma and abs(q0 - p0) < (alpha >> 2) + 2:
            q2 = get(-1)
            if abs(q0 - q2) < beta:
                t = q0 + q1 + p0 + 2
                put(1, (t * 2 + p1 + q2) >> 3)
                put(0, (t + q2) >> 2)
                put(-1, (get(-2) * 2 + q2 * 3 + t + 2) >> 3)
            else:
                put(1, (q1 * 2 + q0 + p1 + 2) >> 2)
            p2 = get(4)
            if abs(p0 - p2) < beta:
                t = p0 + p1 + q0 + 2
                put(2, (t * 2 + q1 + p2) >> 3)
                put(3, (t + p2) >> 2)
                put(4, (get(5) * 2 + p2 * 3 + t + 2) >> 3)
            else:
                put(2, (p1 * 2 + p0 + q1 + 2) >> 2)
        else:
            t = q1 + p1 + 2
            put(1, (q1 + q0 + t) >> 2)
            put(2, (p1 + p0 + t) >> 2)
    else:
        tc0 = T.DEBLOCK_TC0[str_val - 1][alpha_idx + 16]
        if is_luma:
            q2 = get(-1)
            p2 = get(4)
            aq = abs(q2 - q0) < beta
            ap = abs(p2 - p0) < beta
            if tc0:
                if aq or ap:
                    t0 = (p0 + q0 + 1) >> 1
                    if aq:
                        t = (q2 + t0 - q1 * 2) >> 1
                        if t:
                            put(0, _clip3(t, -tc0, tc0) + q1)
                    if ap:
                        t = (p2 + t0 - p1 * 2) >> 1
                        if t:
                            put(3, _clip3(t, -tc0, tc0) + p1)
                tc = tc0 + aq + ap
            else:
                tc = tc0 + aq + ap
                if tc == 0:
                    return
        else:
            tc = tc0 + 1
        delta = ((p0 - q0) * 4 + q1 - p1 + 4) >> 3
        if delta:
            delta = _clip3(delta, -tc, tc)
            put(1, q0 + delta)
            put(2, p0 - delta)


def _edge_strengths(str_byte):
    return [(str_byte >> (2 * j)) & 3 for j in range(4)]


def _filter_edge(plane, y0, x0, axis, str_byte, str4, a, b, is_luma, length):
    """Filter one full edge (luma 16 or chroma 8 samples long). The
    lines across an edge touch disjoint samples, so the benchmark's copy
    filters them on Python lists of the edge's 8-sample strip and writes
    the strip back once (the JAX package's reads and writes each sample
    through numpy); the arithmetic is unchanged."""
    if a < 0:
        return
    if axis == 1:  # vertical edge: rows y0.., samples x0-4 .. x0+3
        win = plane[y0:y0 + length, x0 - 4:x0 + 4]
        lines = win.tolist()
    else:  # horizontal edge: columns x0.., samples y0-4 .. y0+3
        win = plane[y0 - 4:y0 + 4, x0:x0 + length]
        lines = win.T.tolist()
    if str4:
        for seg in lines:
            _filter_line(seg, 4, a, b, is_luma)
    else:
        step = length // 4
        strs = _edge_strengths(str_byte)
        for j in range(4):
            s = strs[j]
            if not s:
                continue
            for seg in lines[j * step:(j + 1) * step]:
                _filter_line(seg, s, a, b, is_luma)
    win[...] = lines if axis == 1 else list(zip(*lines))


def deblock_picture(dec):
    """deblock_pb (h264.cpp:10540-10663) on the decoder's current frame."""
    f = dec.frames[dec.cur_idx]
    max_x, max_y = dec.max_x, dec.max_y
    idc = 0
    a_ofs = b_ofs = 0
    for y in range(max_y):
        for x in range(max_x):
            curr = dec.deblock[y * max_x + x]
            if curr.idc:
                idc = curr.idc - 1
                a_ofs, b_ofs = curr.slicehdr
            if idc == 1:
                continue
            x0, y0 = x * 16, y * 16
            cx, cy = x * 8, y * 8
            strv = curr.str_horiz  # vertical edges (horizontal filtering)
            if x != 0 and (not idc or dec.firstline != max_x) and (strv & 255):
                left = dec.deblock[y * max_x + x - 1]
                qp = (curr.qpy + left.qpy + 1) >> 1
                a, b = _alpha_beta(qp, a_ofs, b_ofs)
                _filter_edge(f.y, y0, x0, 1, strv & 255, curr.str4_horiz, a, b,
                             True, 16)
                for c, pl in ((0, f.cb), (1, f.cr)):
                    qp = (curr.qpc[c] + left.qpc[c] + 1) >> 1
                    a, b = _alpha_beta(qp, a_ofs, b_ofs)
                    _filter_edge(pl, cy, cx, 1, strv & 255, curr.str4_horiz,
                                 a, b, False, 8)
            if strv & ~255:
                a, b = _alpha_beta(curr.qpy, a_ofs, b_ofs)
                for e in range(1, 4):
                    _filter_edge(f.y, y0, x0 + e * 4, 1,
                                 (strv >> (8 * e)) & 255, 0, a, b, True, 16)
                s2 = (strv >> 16) & 255
                if s2:
                    for c, pl in ((0, f.cb), (1, f.cr)):
                        qp = curr.qpc[c]
                        a, b = _alpha_beta(qp, a_ofs, b_ofs)
                        _filter_edge(pl, cy, cx + 4, 1, s2, 0, a, b, False, 8)
            strh = curr.str_vert  # horizontal edges (vertical filtering)
            if y != 0 and (not idc or dec.firstline < 0) and (strh & 255):
                top = dec.deblock[(y - 1) * max_x + x]
                qp = (curr.qpy + top.qpy + 1) >> 1
                a, b = _alpha_beta(qp, a_ofs, b_ofs)
                _filter_edge(f.y, y0, x0, 0, strh & 255, curr.str4_vert, a, b,
                             True, 16)
                for c, pl in ((0, f.cb), (1, f.cr)):
                    qp = (curr.qpc[c] + top.qpc[c] + 1) >> 1
                    a, b = _alpha_beta(qp, a_ofs, b_ofs)
                    _filter_edge(pl, cy, cx, 0, strh & 255, curr.str4_vert,
                                 a, b, False, 8)
            if strh & ~255:
                a, b = _alpha_beta(curr.qpy, a_ofs, b_ofs)
                for e in range(1, 4):
                    _filter_edge(f.y, y0 + e * 4, x0, 0,
                                 (strh >> (8 * e)) & 255, 0, a, b, True, 16)
                s2 = (strh >> 16) & 255
                if s2:
                    for c, pl in ((0, f.cb), (1, f.cr)):
                        qp = curr.qpc[c]
                        a, b = _alpha_beta(qp, a_ofs, b_ofs)
                        _filter_edge(pl, cy + 4, cx, 0, s2, 0, a, b, False, 8)
